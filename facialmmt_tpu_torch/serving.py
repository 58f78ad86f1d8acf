"""Fixed-shape batched serving (counterpart of facialmmt_tpu/serving.py's
EmotionServer).

Variable-size requests are padded on the host into one static pack:
  * up to `max_batch` utterances per call;
  * up to `face_capacity` face crops of 160x160x3 uint8, packed contiguously;
  * missing modalities zero-masked.
The pipeline's weights go to the device once, in `dtype` (bf16 by default);
each call copies the pack over, runs the eval transform and the pipeline, and
returns softmax probability rows.  The eval-time gumbel draw is sampled from
a torch.Generator on the device, seeded from runtime.seed, unless
runtime.deterministic_gumbel is set.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from facialmmt_tpu_torch.config import FacialMMTConfig
from facialmmt_tpu_torch.data.image_pipeline import meld_face_eval_transform
from facialmmt_tpu_torch.data.meld import FaceCapacityError  # noqa: F401
from facialmmt_tpu_torch.models.pipeline import build_pipeline
from facialmmt_tpu_torch.ops.kernels import resolve_device

FACE_SHAPE = (160, 160, 3)


class EmotionServer:
    def __init__(self, cfg: FacialMMTConfig, state_dict=None,
                 max_batch: int = 8, face_capacity: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 transfer_dtype=np.float16, device="cuda"):
        """`state_dict`: the pipeline's weights under the reference names
        (checkpoint/from_jax.py builds one from JAX variables); None draws
        random weights from runtime.seed.  `transfer_dtype` is the host wire
        format of the padded audio/vision features, restored to fp32 on the
        device.  `device` defaults to the card; without a CUDA device the
        constructor raises (pass "cpu" to serve on the CPU).  The server warms
        up with one all-padding pack."""
        self.cfg = cfg
        self.max_batch = max_batch
        self.face_capacity = face_capacity
        self.dtype = dtype
        self.transfer_dtype = transfer_dtype
        self.device = resolve_device(device)
        model = build_pipeline(cfg, self.device, state_dict)
        self.model = model.to(dtype).eval()
        self.generator = torch.Generator(self.device).manual_seed(
            cfg.runtime.seed)
        self.predict_raw(self._zero_batch(),
                         np.zeros((face_capacity,) + FACE_SHAPE, np.uint8))

    def _zero_batch(self) -> Dict[str, np.ndarray]:
        d = self.cfg.data
        b = self.max_batch
        return {
            "dia_input_ids": np.full((b, d.max_seq_length), 1, np.int32),
            "dia_input_mask": np.zeros((b, d.max_seq_length), np.int32),
            "dia_sep_mask": np.zeros((b, d.max_seq_length), np.int32),
            "dia_idx": np.zeros(b, np.int32),
            "utt_in_dia_idx": np.zeros(b, np.int32),
            "audio_inputs": np.zeros((b, d.audio_utt_max_len,
                                      d.audio_feat_dim), self.transfer_dtype),
            "audio_mask": np.zeros((b, d.audio_utt_max_len), np.int32),
            "vision_feats": np.zeros((b, d.vision_utt_max_len,
                                      d.vision_feat_dim), self.transfer_dtype),
            "n_faces": np.zeros(b, np.int32),
            "face_utt_id": np.full(self.face_capacity, -1, np.int32),
            "face_pos": np.zeros(self.face_capacity, np.int32),
        }

    @torch.no_grad()
    def predict_device(self, batch: Dict[str, np.ndarray],
                       faces_raw: np.ndarray) -> torch.Tensor:
        """Run one pack; returns the (max_batch, num_labels) probability rows
        on the device without waiting for them."""
        dev = self.device
        full = {k: torch.from_numpy(np.asarray(v)).to(dev, non_blocking=True)
                for k, v in batch.items()}
        full["audio_inputs"] = full["audio_inputs"].float()
        full["vision_feats"] = full["vision_feats"].float()
        faces = torch.from_numpy(np.asarray(faces_raw)).to(dev)
        full["faces"] = meld_face_eval_transform(
            faces.float(), self.cfg.data.swin_img_size).to(self.dtype)
        logits = self.model(full, generator=self.generator)
        return torch.softmax(logits.float(), dim=-1)

    def predict_raw(self, batch: Dict[str, np.ndarray],
                    faces_raw: np.ndarray) -> np.ndarray:
        """One fixed-shape inference; (max_batch, num_labels) rows."""
        return self.predict_device(batch, faces_raw).cpu().numpy()

    def predict(self, requests) -> list:
        """requests: list (<= max_batch) of dicts with optional keys
        {'audio' (La, da), 'vision' (Lv, dv), 'faces' (n, 160, 160, 3),
         'input_ids', 'sep_mask', 'utt_in_dia_idx'}.
        Returns one probability vector per request."""
        batch, faces_raw = self.build_pack(requests)
        probs = self.predict_raw(batch, faces_raw)
        return [probs[j] for j in range(len(requests))]

    def build_pack(self, requests):
        """Pad <= max_batch requests into the static shapes; over-long text,
        audio and vision are truncated, too many faces raise
        FaceCapacityError.  Returns (batch dict, faces_raw)."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests > max_batch "
                             f"{self.max_batch}")
        batch = self._zero_batch()
        faces_raw = np.zeros((self.face_capacity,) + FACE_SHAPE, np.uint8)
        cursor = 0
        for j, req in enumerate(requests):
            if "input_ids" in req:
                max_len = batch["dia_input_ids"].shape[1]
                ids = np.asarray(req["input_ids"])[:max_len]
                batch["dia_input_ids"][j, :len(ids)] = ids
                batch["dia_input_mask"][j, :len(ids)] = 1
                sep = np.asarray(req.get("sep_mask", []))[:max_len]
                batch["dia_sep_mask"][j, :len(sep)] = sep
                batch["utt_in_dia_idx"][j] = req.get("utt_in_dia_idx", 0)
            batch["dia_idx"][j] = j
            if "audio" in req:
                a = np.asarray(req["audio"])
                la = min(a.shape[0], batch["audio_inputs"].shape[1])
                batch["audio_inputs"][j, :la] = a[:la]
                batch["audio_mask"][j, :la] = 1
            if "vision" in req:
                v = np.asarray(req["vision"])
                lv = min(v.shape[0], batch["vision_feats"].shape[1])
                batch["vision_feats"][j, :lv] = v[:lv]
            faces = req.get("faces")
            if faces is not None:
                take = self.face_take(faces)
                if cursor + take > self.face_capacity:
                    raise FaceCapacityError(cursor + take, self.face_capacity,
                                            "serving")
                faces_raw[cursor:cursor + take] = np.asarray(faces[:take],
                                                             np.uint8)
                batch["face_utt_id"][cursor:cursor + take] = j
                batch["face_pos"][cursor:cursor + take] = np.arange(
                    take, dtype=np.int32)
                cursor += take
                batch["n_faces"][j] = take
        return batch, faces_raw

    def face_take(self, faces) -> int:
        """How many of a request's face crops enter the pack (the reference's
        per-utterance cap, utils/dataset.py:278-279)."""
        return min(len(faces), self.cfg.data.vision_utt_max_len)

    def benchmark_latency(self, iters: int = 20) -> Dict[str, float]:
        """Host-clock latency of `iters` all-padding packs, each ending in a
        copy of the result to the host."""
        batch = self._zero_batch()
        faces = np.zeros((self.face_capacity,) + FACE_SHAPE, np.uint8)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self.predict_raw(batch, faces)
            times.append(time.perf_counter() - t0)
        arr = np.asarray(times) * 1000
        return {"p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
                "mean_ms": float(arr.mean())}
