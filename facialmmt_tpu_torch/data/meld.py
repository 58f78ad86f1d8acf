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

The file side reads the reference's preprocessed MELD layout under
`data_load_path` (reference utils/dataset.py:160-307):
  * `V/meld_{split}_vision_utt.pkl` (MeldVisionDataset, the V-only model) and
    `T+A+V/meld_{split}_{audio,vision}_utt.pkl`: precomputed utterance
    features (wav2vec2 768-d audio, InceptionResnet 512-d vision), masks and
    labels, parsed once into an npz cache beside them that is rebuilt when a
    pickle is newer;
  * `{split}_utt_profile.json`: utterance index -> [utt_name, dia_name,
    dia_idx, dia_len, utt_in_dia_idx];
  * `{split}_facseqs_160_paths_final.json`: utterance name -> face JPEGs;
  * the tokenized dialogues (data/text_prep.py, cached as npz by main.py).
The host only decodes JPEGs (native/, BGR order kept); resize, augmentation
and normalisation run on the device (data/image_pipeline.py).  Face lists
longer than vision_utt_max_len truncate (reference :278-279).
SyntheticMeldDataset and SyntheticFerDataset build the same batches in memory
from a numpy seed, for tests and smoke runs.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from facialmmt_tpu_torch.config import FacialMMTConfig

RAW_FACE_SIZE = 160  # MELD face crops are 160 px (reference README.md:116)


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


# ------------------------------------------------------------- file datasets --

def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _cached_arrays(cache_path: str, sources: Sequence[str], build):
    """`build()` -> dict[str, np.ndarray], cached as one npz at `cache_path`
    and rebuilt whenever a source file is newer than the cache (reference
    utils/util.py:90-115 caches whole datasets the same way).  A data
    directory that cannot be written runs uncached."""
    try:
        cache_mtime = os.path.getmtime(cache_path)
        if all(os.path.getmtime(s) <= cache_mtime for s in sources):
            with np.load(cache_path) as z:
                return {k: z[k] for k in z.files}
    except (OSError, ValueError):
        pass
    arrays = build()
    try:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        tmp = cache_path + ".tmp.npz"  # savez appends .npz unless present
        np.savez(tmp, **arrays)
        os.replace(tmp, cache_path)
    except OSError:
        pass
    return arrays


@dataclass
class MeldTextArrays:
    input_ids: np.ndarray   # (num_dia, max_seq_length)
    input_mask: np.ndarray
    sep_mask: np.ndarray


class MeldVisionDataset:
    """The V-only split (reference utils/dataset.py:160-189):
    V/meld_{split}_vision_utt.pkl -> features, masks, labels.  Batches are
    {'feats', 'mask', 'labels'}."""

    def __init__(self, data_load_path: str, split: str, cache: bool = True):
        path = os.path.join(data_load_path, "V",
                            f"meld_{split}_vision_utt.pkl")

        def build():
            data = _load_pickle(path)[split]
            return {
                "vision": np.asarray(data["vision"], np.float32),
                "vision_mask": np.asarray(data["vision_utt_mask"], np.int32),
                "labels": np.asarray(data["labels"], np.int64),
            }

        arrays = (_cached_arrays(path + ".npz", [path], build)
                  if cache else build())
        self.features = arrays["vision"]
        self.mask = arrays["vision_mask"]
        self.labels = arrays["labels"]

    def __len__(self):
        return self.features.shape[0]

    @property
    def max_utt_len(self):
        return self.features.shape[1]

    @property
    def feat_dim(self):
        return self.features.shape[-1]

    def get_batch(self, indices: Sequence[int]):
        idx = np.asarray(indices)
        return {"feats": self.features[idx], "mask": self.mask[idx],
                "labels": self.labels[idx]}


class MeldMultimodalDataset:
    """The T+A+V split: text arrays, audio and vision pickles, face JPEGs.
    `get_batch(indices, face_capacity)` follows the protocol at the top of
    this module."""

    def __init__(self, data_load_path: str, split: str,
                 text_arrays: MeldTextArrays, choice_modality: str = "T+A+V",
                 cache: bool = True):
        base = os.path.join(data_load_path, choice_modality)
        self.split = split
        self.text = text_arrays
        audio_pkl = os.path.join(base, f"meld_{split}_audio_utt.pkl")
        vision_pkl = os.path.join(base, f"meld_{split}_vision_utt.pkl")

        def build():
            audio = _load_pickle(audio_pkl)[split]
            vision = _load_pickle(vision_pkl)[split]
            return {
                "audio": np.asarray(audio["audio"], np.float32),
                "audio_mask": np.asarray(audio["audio_utt_mask"], np.int32),
                "vision": np.asarray(vision["vision"], np.float32),
                "vision_mask": np.asarray(vision["vision_utt_mask"], np.int32),
                "labels": np.asarray(vision["labels"], np.int64),
            }

        arrays = (_cached_arrays(
            os.path.join(base, f"meld_{split}_features.npz"),
            [audio_pkl, vision_pkl], build) if cache else build())
        self.audio = arrays["audio"]
        self.audio_mask = arrays["audio_mask"]
        self.vision = arrays["vision"]
        self.vision_mask = arrays["vision_mask"]
        self.labels = arrays["labels"]
        with open(os.path.join(base, f"{split}_utt_profile.json"),
                  encoding="utf8") as f:
            self.utt_profile = json.load(f)
        with open(os.path.join(base, f"{split}_facseqs_160_paths_final.json"),
                  encoding="utf8") as f:
            self.utt_face_path = json.load(f)
        self._check_face_mask_consistency()

    def _check_face_mask_consistency(self):
        """The reference drives the Swin input off the face-path counts and
        the filter's fallback off the pickle's vision mask, assuming they
        agree (reference train.py:60-71 vs :122-133); a dataset where they
        disagree raises here."""
        f_max = self.vision.shape[1]
        mask_counts = self.vision_mask.sum(axis=1)
        bad = []
        for i_str, prof in self.utt_profile.items():
            name = prof[0]
            n_paths = min(len(self.utt_face_path.get(name, [])), f_max)
            if n_paths != int(mask_counts[int(i_str)]):
                bad.append((name, n_paths, int(mask_counts[int(i_str)])))
        if bad:
            head = ", ".join(f"{n}: {p} paths vs mask {m}"
                             for n, p, m in bad[:5])
            raise ValueError(
                f"{self.split}: face-path counts disagree with the pkl "
                f"vision mask for {len(bad)} utterance(s) ({head}) — the "
                f"reference assumes these are equal (train.py:60-133)")

    def __len__(self):
        return self.vision.shape[0]

    @property
    def audio_max_utt_len(self):
        return self.audio.shape[1]

    @property
    def vision_max_utt_len(self):
        return self.vision.shape[1]

    @property
    def audio_feat_dim(self):
        return self.audio.shape[-1]

    @property
    def vision_feat_dim(self):
        return self.vision.shape[-1]

    def _decode_faces(self, paths: List[str]) -> np.ndarray:
        """Host-side decode only, to the canonical 160 px (native/)."""
        from facialmmt_tpu_torch.native import decode_images

        return decode_images(paths, RAW_FACE_SIZE)

    def get_batch(self, indices: Sequence[int], face_capacity: int):
        """One static-shape batch: B utterances, B dialogue slots (each
        dialogue once, padded by repeating the first), and every face up to
        the per-utterance cap packed into `face_capacity` slots (reference
        train.py:60-71); a batch that needs more raises FaceCapacityError."""
        idx = list(indices)
        b = len(idx)
        f_max = self.vision_max_utt_len
        dia_slots: Dict[int, int] = {}
        dia_idx = np.zeros(b, np.int32)
        utt_in_dia_idx = np.zeros(b, np.int32)
        utt_names = []
        for j, i in enumerate(idx):
            utt_name, _dia_name, dia_i, _dia_len, utt_pos = \
                self.utt_profile[str(i)]
            utt_names.append(utt_name)
            dia_idx[j] = dia_slots.setdefault(dia_i, len(dia_slots))
            utt_in_dia_idx[j] = utt_pos
        slot_to_dia = {v: k for k, v in dia_slots.items()}
        dia_rows = [slot_to_dia.get(s, slot_to_dia[0]) for s in range(b)]

        face_lists = [self.utt_face_path.get(n, [])[:f_max]
                      for n in utt_names]
        needed = sum(len(p) for p in face_lists)
        if needed > face_capacity:
            raise FaceCapacityError(needed, face_capacity, self.split)
        n_faces = np.asarray([len(p) for p in face_lists], np.int32)
        face_utt_id = np.full(face_capacity, -1, np.int32)
        face_pos = np.zeros(face_capacity, np.int32)
        face_utt_id[:needed] = np.repeat(np.arange(b, dtype=np.int32),
                                         n_faces)
        face_pos[:needed] = np.concatenate(
            [np.arange(k, dtype=np.int32) for k in n_faces]
            or [np.zeros(0, np.int32)])
        faces_raw = np.zeros((face_capacity, RAW_FACE_SIZE, RAW_FACE_SIZE, 3),
                             np.uint8)
        if needed:
            faces_raw[:needed] = self._decode_faces(
                [p for paths in face_lists for p in paths])
        return {
            "dia_input_ids": self.text.input_ids[dia_rows],
            "dia_input_mask": self.text.input_mask[dia_rows],
            "dia_sep_mask": self.text.sep_mask[dia_rows],
            "dia_idx": dia_idx,
            "utt_in_dia_idx": utt_in_dia_idx,
            "audio_inputs": self.audio[idx],
            "audio_mask": self.audio_mask[idx],
            "vision_feats": self.vision[idx],
            "vision_mask": self.vision_mask[idx],
            "n_faces": n_faces,
            "faces_raw": faces_raw,
            "face_utt_id": face_utt_id,
            "face_pos": face_pos,
            "labels": self.labels[idx].astype(np.int32),
        }
