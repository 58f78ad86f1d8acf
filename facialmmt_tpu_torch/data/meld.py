"""The MELD dataset protocol the trainer consumes (counterpart of the batch
side of facialmmt_tpu/data/meld.py).

A target-task dataset is any object with
  * ``__len__()``: the number of utterances;
  * ``get_batch(indices, face_capacity)``: a dict of numpy arrays in the
    packed-face layout (models/pipeline.py): ``dia_input_ids``,
    ``dia_input_mask``, ``dia_sep_mask`` (B dialogue slots, L tokens),
    ``dia_idx``, ``utt_in_dia_idx``, ``audio_inputs``, ``audio_mask``,
    ``vision_feats``, ``vision_mask``, ``n_faces``, ``faces_raw``
    (face_capacity, 160, 160, 3) uint8, ``face_utt_id``, ``face_pos`` and
    ``labels``; it raises FaceCapacityError when the batch's faces do not fit.
An auxiliary FER dataset has ``__len__()`` and ``get_batch(indices)`` returning
``(images uint8 (N, H, W, 3), labels int)``.

The file-backed loaders (annotation CSVs, feature pickles, face JPEGs) are not
ported yet; SyntheticMeldDataset and SyntheticFerDataset build the same batches
in memory from a numpy seed, for tests and smoke runs.
"""

from __future__ import annotations

import numpy as np

from facialmmt_tpu_torch.config import FacialMMTConfig

RAW_FACE_SIZE = 160


class FaceCapacityError(ValueError):
    """A batch needs more packed-face slots than the static buffer provides.
    Carries `required`, the slot count the batch needs, so callers can
    escalate to a larger bucket (train/trainer.py does)."""

    def __init__(self, required: int, capacity: int, split: str = ""):
        self.required = required
        self.capacity = capacity
        super().__init__(
            f"face-packing overflow{f' ({split})' if split else ''}: batch "
            f"needs {required} face slots but face_capacity={capacity}; "
            f"escalate the capacity bucket or lower the batch size")


class SyntheticMeldDataset:
    """`n_utts` utterances spread round-robin over `n_dialogues` random
    dialogues, `faces_per_utt` faces each (an int, or one count per
    utterance), every array drawn from `seed`."""

    def __init__(self, cfg: FacialMMTConfig, n_utts: int, n_dialogues: int,
                 faces_per_utt=4, seed: int = 0, split: str = "synthetic"):
        d = cfg.data
        rng = np.random.default_rng(seed)
        self.split = split
        self.f_max = d.vision_utt_max_len
        length = d.max_seq_length
        utts_per_dia = -(-n_utts // n_dialogues)
        self.input_ids = rng.integers(3, cfg.text.vocab_size,
                                      size=(n_dialogues, length)
                                      ).astype(np.int32)
        self.input_mask = np.ones((n_dialogues, length), np.int32)
        # utterance u of a dialogue ends at a separator token
        self.sep_mask = np.zeros((n_dialogues, length), np.int32)
        span = max((length - 2) // utts_per_dia, 2)
        for u in range(utts_per_dia):
            self.sep_mask[:, min(1 + (u + 1) * span - 1, length - 1)] = 1
        self.dia_of = np.arange(n_utts) % n_dialogues
        self.pos_of = np.arange(n_utts) // n_dialogues
        self.audio = rng.normal(size=(n_utts, d.audio_utt_max_len,
                                      d.audio_feat_dim)).astype(np.float32)
        self.audio_mask = np.ones((n_utts, d.audio_utt_max_len), np.int32)
        self.vision = rng.normal(size=(n_utts, d.vision_utt_max_len,
                                       d.vision_feat_dim)).astype(np.float32)
        self.n_faces = np.minimum(
            np.broadcast_to(np.asarray(faces_per_utt), (n_utts,)), self.f_max
        ).astype(np.int32)
        self.vision_mask = (np.arange(d.vision_utt_max_len)[None]
                            < self.n_faces[:, None]).astype(np.int32)
        self.labels = rng.integers(0, cfg.num_labels, size=n_utts
                                   ).astype(np.int32)
        self.face_seed = seed

    def __len__(self) -> int:
        return len(self.labels)

    def get_batch(self, indices, face_capacity: int):
        idx = np.asarray(list(indices))
        b = len(idx)
        slots: dict[int, int] = {}
        dia_idx = np.zeros(b, np.int32)
        for j, i in enumerate(idx):
            dia_idx[j] = slots.setdefault(int(self.dia_of[i]), len(slots))
        first = next(iter(slots))
        by_slot = {v: k for k, v in slots.items()}
        # B dialogue slots, padded by repeating the first dialogue
        rows = [by_slot.get(s, first) for s in range(b)]
        n_faces = self.n_faces[idx]
        needed = int(n_faces.sum())
        if needed > face_capacity:
            raise FaceCapacityError(needed, face_capacity, self.split)
        face_utt_id = np.full(face_capacity, -1, np.int32)
        face_pos = np.zeros(face_capacity, np.int32)
        face_utt_id[:needed] = np.repeat(np.arange(b), n_faces)
        face_pos[:needed] = np.concatenate(
            [np.arange(k) for k in n_faces] or [np.zeros(0, np.int32)])
        faces_raw = np.zeros((face_capacity, RAW_FACE_SIZE, RAW_FACE_SIZE, 3),
                             np.uint8)
        rng = np.random.default_rng([self.face_seed, *idx.tolist()])
        faces_raw[:needed] = rng.integers(
            0, 256, size=(needed, RAW_FACE_SIZE, RAW_FACE_SIZE, 3),
            dtype=np.uint8)
        return {
            "dia_input_ids": self.input_ids[rows],
            "dia_input_mask": self.input_mask[rows],
            "dia_sep_mask": self.sep_mask[rows],
            "dia_idx": dia_idx,
            "utt_in_dia_idx": self.pos_of[idx].astype(np.int32),
            "audio_inputs": self.audio[idx],
            "audio_mask": self.audio_mask[idx],
            "vision_feats": self.vision[idx],
            "vision_mask": self.vision_mask[idx],
            "n_faces": n_faces,
            "faces_raw": faces_raw,
            "face_utt_id": face_utt_id,
            "face_pos": face_pos,
            "labels": self.labels[idx],
        }


class SyntheticFerDataset:
    """`n` random uint8 images of `size` px with labels, drawn from `seed`."""

    def __init__(self, n: int, size: int = 112, num_labels: int = 7,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, size=(n, size, size, 3),
                                   dtype=np.uint8)
        self.labels = rng.integers(0, num_labels, size=n).astype(np.int32)

    def __len__(self) -> int:
        return len(self.labels)

    def get_batch(self, indices):
        idx = np.asarray(list(indices))
        return self.images[idx], self.labels[idx]
