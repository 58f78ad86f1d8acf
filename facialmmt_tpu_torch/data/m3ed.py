"""M3ED (appendix) dataset layer (counterpart of facialmmt_tpu/data/m3ed.py;
pure Python and numpy on both sides, beside the span recorder here).

The appendix's three dataset classes (reference
(Appendix)CCAC2023/utils/dataset.py):

  * `M3edTextDataset` — `loading_unimodal_text` (:112-147): one sample per
    utterance, text = the whole parent dialogue, label read from the
    per-token label channel at the utterance's sep position;
  * `M3edMultimodalDataset` — `loading_multimodal_dataset` with
    --uttORdia utt (:165-302): text arrays + `m3ed_{split}_audio_utt.pkl` /
    `m3ed_{split}_vision_utt.pkl` feature pickles + `{split}_utt_profile.json`
    (M3ED feeds precomputed vision features — no face JPEGs / FER branch);
  * `M3edDialogueDataset` — the same class with --uttORdia dia: 4-D
    per-dialogue pickles `m3ed_{split}_{audio,vision}_dia.pkl`
    ((num_dia, max_dia_len, max_utt_len, dim) features, `*_utt_mask`,
    `*_dia_mask`, per-dialogue `labels`) + `{split}_num_utt_in_dia.json`.

Batching follows data/meld.py: each batch's dialogues are deduplicated
(encoded once, gathered per utterance by `dia_idx`) and every batch has a
fixed shape.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Sequence

import numpy as np

from facialmmt_tpu_torch.utils.observability import (add_row, stamp,
                                                     trace_span)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _labels_or_raise(data: Dict, split: str, shape) -> np.ndarray:
    """Labels from the audio pickle.  Unlabeled TEST/submission pickles get a
    zeros placeholder (predictions only — reference (Appendix)CCAC2023/
    train.py:156-194 never reads test labels), but a train/val pickle missing
    its 'labels' key is a malformed dataset: training on a zeros placeholder
    would silently learn garbage, so raise instead."""
    if "labels" in data:
        return np.asarray(data["labels"], np.int64)
    if split in ("train", "val", "valid", "dev"):
        raise KeyError(
            f"m3ed {split} audio pickle has no 'labels' key — refusing to "
            f"substitute zeros for a training/validation split (check the "
            f"pickle layout: {{'{split}': {{'audio', 'audio_utt_mask', "
            f"'labels'}}}})")
    return np.zeros(shape, np.int64)


class M3edTextDataset:
    """Utterance-level text-only dataset over per-dialogue arrays.

    Arrays come from M3edTextPreprocessor.to_arrays (or any source with the
    same layout): input_ids/input_mask/sep_mask/label_ids all (num_dia, L).
    The utterance->dialogue profile the reference stores in
    {split}_utt_profile.json is derived here from the sep layout itself —
    utterance u of dialogue d is the u-th sep position of row d (reference
    utils/dataset.py:131-146 reads the same structure from the profile file).
    """

    def __init__(self, input_ids: np.ndarray, input_mask: np.ndarray,
                 sep_mask: np.ndarray, label_ids: np.ndarray):
        self.input_ids = np.asarray(input_ids, np.int32)
        self.input_mask = np.asarray(input_mask, np.int32)
        self.sep_mask = np.asarray(sep_mask, np.int32)
        self.label_ids = np.asarray(label_ids, np.int32)

        # per-utterance index: (dia_row, utt_in_dia_idx, label)
        self._dia_row = []
        self._utt_pos = []
        self._labels = []
        for d in range(self.sep_mask.shape[0]):
            sep_positions = np.nonzero(self.sep_mask[d])[0]
            for pos, sp in enumerate(sep_positions):
                self._dia_row.append(d)
                self._utt_pos.append(pos)
                self._labels.append(int(self.label_ids[d, sp]))
        self._dia_row = np.asarray(self._dia_row, np.int32)
        self._utt_pos = np.asarray(self._utt_pos, np.int32)
        self._labels = np.asarray(self._labels, np.int32)

    def __len__(self) -> int:
        return len(self._labels)

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Static-shape batch in the multimodal layout (text keys only):
        B dialogue slots (deduped, pad-by-repeat), dia_idx gather vector."""
        idx = np.asarray(list(indices))
        b = len(idx)
        dia_slots: Dict[int, int] = {}
        dia_idx = np.zeros(b, np.int32)
        for j, i in enumerate(idx):
            d = int(self._dia_row[i])
            if d not in dia_slots:
                dia_slots[d] = len(dia_slots)
            dia_idx[j] = dia_slots[d]
        slot_to_dia = {v: k for k, v in dia_slots.items()}
        rows = [slot_to_dia.get(s, slot_to_dia[0]) for s in range(b)]
        return {
            "dia_input_ids": self.input_ids[rows],
            "dia_input_mask": self.input_mask[rows],
            "dia_sep_mask": self.sep_mask[rows],
            "dia_idx": dia_idx,
            "utt_in_dia_idx": self._utt_pos[idx],
            "labels": self._labels[idx],
        }


class M3edMultimodalDataset:
    """Utterance-level M3ED multimodal split (reference
    (Appendix)CCAC2023/utils/dataset.py:165-302, --uttORdia utt).

    Reads the reference's exact pickle layout:
      m3ed_{split}_audio_utt.pkl -> {split: {audio (num_utt, La, Da),
                                             audio_utt_mask, labels}}
      m3ed_{split}_vision_utt.pkl -> {split: {vision (num_utt, Lv, Dv),
                                              vision_utt_mask}}
      {split}_utt_profile.json    -> utt idx -> [utt, dia, dia_idx, len, pos]

    Vision is precomputed features only (no faces, no FER concat — the
    appendix model's vision_emb_dim is the raw extractor dim, reference
    (Appendix)CCAC2023/src/models.py:46).
    """

    def __init__(self, project_path: str, split: str, input_ids, input_mask,
                 sep_mask):
        self.split = split
        self.text_input_ids = np.asarray(input_ids, np.int32)
        self.text_input_mask = np.asarray(input_mask, np.int32)
        self.text_sep_mask = np.asarray(sep_mask, np.int32)

        audio = _load_pickle(os.path.join(
            project_path, f"m3ed_{split}_audio_utt.pkl"))[split]
        self.audio = np.asarray(audio["audio"], np.float32)
        self.audio_mask = np.asarray(audio["audio_utt_mask"], np.int32)
        self.labels = _labels_or_raise(audio, split, self.audio.shape[0])

        vision = _load_pickle(os.path.join(
            project_path, f"m3ed_{split}_vision_utt.pkl"))[split]
        self.vision = np.asarray(vision["vision"], np.float32)
        self.vision_mask = np.asarray(vision["vision_utt_mask"], np.int32)

        with open(os.path.join(project_path, f"{split}_utt_profile.json"),
                  encoding="utf8") as f:
            self.utt_profile = json.load(f)

    def __len__(self):
        return self.audio.shape[0]

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

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Static-shape batch: B dialogue slots (deduped, pad-by-repeat) +
        per-utterance feature rows.  Keys match the feature-modality model
        path (models/multimodal.py with vision_inputs = raw features)."""
        idx = list(indices)
        b = len(idx)
        dia_slots: Dict[int, int] = {}
        dia_idx = np.zeros(b, np.int32)
        utt_in_dia_idx = np.zeros(b, np.int32)
        for j, i in enumerate(idx):
            _, _, dia_i, _, utt_pos = self.utt_profile[str(i)]
            if dia_i not in dia_slots:
                dia_slots[dia_i] = len(dia_slots)
            dia_idx[j] = dia_slots[dia_i]
            utt_in_dia_idx[j] = utt_pos
        slot_to_dia = {v: k for k, v in dia_slots.items()}
        rows = [slot_to_dia.get(s, slot_to_dia[0]) for s in range(b)]
        return {
            "dia_input_ids": self.text_input_ids[rows],
            "dia_input_mask": self.text_input_mask[rows],
            "dia_sep_mask": self.text_sep_mask[rows],
            "dia_idx": dia_idx,
            "utt_in_dia_idx": utt_in_dia_idx,
            "audio_inputs": self.audio[idx],
            "audio_mask": self.audio_mask[idx],
            "vision_inputs": self.vision[idx],
            "vision_mask": self.vision_mask[idx],
            "labels": self.labels[idx].astype(np.int32),
        }


class M3edDialogueDataset:
    """Dialogue-level M3ED multimodal split (reference
    (Appendix)CCAC2023/utils/dataset.py:165-302, --uttORdia dia).

    Reads the 4-D per-dialogue pickles directly:
      m3ed_{split}_audio_dia.pkl -> {split: {audio (num_dia, D, La, Da),
          audio_utt_mask (num_dia, D, La), audio_dia_mask (num_dia, D),
          labels (num_dia, D)}}
      m3ed_{split}_vision_dia.pkl -> same layout for vision
      {split}_num_utt_in_dia.json -> {dia idx: num utterances}

    get_batch emits the same layout MeldDialogueDataset does, so
    DialogueTrainer and DialogueMultiModalTransformer consume either source.
    from_arrays builds the same dataset from arrays in memory.
    """

    def __init__(self, project_path: str, split: str, input_ids, input_mask,
                 sep_mask):
        audio = _load_pickle(os.path.join(
            project_path, f"m3ed_{split}_audio_dia.pkl"))[split]
        vision = _load_pickle(os.path.join(
            project_path, f"m3ed_{split}_vision_dia.pkl"))[split]
        with open(os.path.join(project_path,
                               f"{split}_num_utt_in_dia.json"),
                  encoding="utf8") as f:
            num_utt_in_dia = json.load(f)
        self._set_arrays(
            split, input_ids, input_mask, sep_mask, audio["audio"],
            audio["audio_utt_mask"], vision["vision"],
            vision["vision_utt_mask"], vision["vision_dia_mask"],
            _labels_or_raise(audio, split, np.shape(audio["audio"])[:2]),
            num_utt_in_dia)

    @classmethod
    def from_arrays(cls, split: str, input_ids, input_mask, sep_mask, audio,
                    audio_mask, vision, vision_mask, dia_mask,
                    labels) -> "M3edDialogueDataset":
        """The dataset from arrays in the pickles' layout (text (num_dia,
        L); audio / vision (num_dia, D, L*, dim) and their (num_dia, D,
        L*) masks; dia_mask and labels (num_dia, D)), without files.
        num_utt_in_dia is each dialogue's count of dia_mask."""
        ds = cls.__new__(cls)
        num_utt_in_dia = {str(d): int(n) for d, n in
                          enumerate(np.asarray(dia_mask).sum(1))}
        ds._set_arrays(split, input_ids, input_mask, sep_mask, audio,
                       audio_mask, vision, vision_mask, dia_mask,
                       np.asarray(labels, np.int64), num_utt_in_dia)
        return ds

    def _set_arrays(self, split, input_ids, input_mask, sep_mask, audio,
                    audio_mask, vision, vision_mask, dia_mask, labels,
                    num_utt_in_dia):
        self.split = split
        self.text_input_ids = np.asarray(input_ids, np.int32)
        self.text_input_mask = np.asarray(input_mask, np.int32)
        self.text_sep_mask = np.asarray(sep_mask, np.int32)
        self.audio = np.asarray(audio, np.float32)
        self.audio_mask = np.asarray(audio_mask, np.int32)
        self.labels = labels
        self.vision = np.asarray(vision, np.float32)
        self.vision_mask = np.asarray(vision_mask, np.int32)
        self.dia_mask = np.asarray(dia_mask, np.int32)
        self.num_utt_in_dia = num_utt_in_dia

    def __len__(self):
        return self.audio.shape[0]

    @property
    def max_dia_len(self):
        return self.audio.shape[1]

    @property
    def audio_max_utt_len(self):
        return self.audio.shape[2]

    @property
    def vision_max_utt_len(self):
        return self.vision.shape[2]

    @property
    def audio_feat_dim(self):
        return self.audio.shape[-1]

    @property
    def vision_feat_dim(self):
        return self.vision.shape[-1]

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """The rows `indices`.  The span `fmmt.data.fetch`; with the span
        recorder on, a counter row `fmmt.data.slots` whose value is
        (valid utterances, utterance slots) of the batch, read from the
        host's dia_mask."""
        idx = list(indices)
        with trace_span("fmmt.data.fetch"):
            batch = {
                "dia_input_ids": self.text_input_ids[idx],
                "dia_input_mask": self.text_input_mask[idx],
                "dia_sep_mask": self.text_sep_mask[idx],
                "audio_inputs": self.audio[idx],
                "audio_mask": self.audio_mask[idx],
                "vision_inputs": self.vision[idx],
                "vision_mask": self.vision_mask[idx],
                "dia_mask": self.dia_mask[idx],
                "labels": self.labels[idx].astype(np.int32),
            }
        t = stamp()
        if t is not None:
            mask = batch["dia_mask"]
            add_row("fmmt.data.slots", t, t,
                    value=(int(mask.sum()), int(mask.size)))
        return batch
