"""MELD dialogue text preprocessing (counterpart of the MELD half of
facialmmt_tpu/data/text_prep.py; pure Python and numpy on both sides).

Rebuild of the reference's tokenize-whole-dialogue pipeline
(reference src/meld_bert_extraText.py:11-130):
  * read {split}_sent_emo.csv for the dialogue->utterance map (make_text_dia);
  * tokenize each utterance, then greedily truncate the LONGEST utterance one
    token at a time until the dialogue fits the budget (_truncate_seq_pair,
    reference :22-46) — budget is 512-68 for RoBERTa (</s></s> separators) and
    512-34 for BERT ([SEP]) (reference :92-95);
  * join as <s>u1</s></s>u2</s>... (RoBERTa) or [CLS]u1[SEP]u2[SEP]... (BERT)
    with sep_mask = 1 on each utterance-final separator (reference :97-112);
  * pad ids/mask/sep_mask to 512.

The tokenizer is dependency-injected: anything exposing .tokenize(str)->[str]
and .convert_tokens_to_ids([str])->[int] works (HF tokenizers do; tests use a
tiny whitespace tokenizer).  Output arrays are int32 numpy.
The M3ED half of the JAX module belongs to the appendix and is not ported.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

MAX_SEQ_LENGTH = 512  # reference src/meld_bert_extraText.py:9


def make_text_dia(csv_path: str) -> Dict[str, List[str]]:
    """CSV -> {dialogue_id: [dia{d}_utt{u}, ...]} (reference :11-19).
    Plain-csv implementation (no pandas dependency in the hot path)."""
    import csv

    dia_utt_list: Dict[str, List[str]] = defaultdict(list)
    with open(csv_path, encoding="utf8") as f:
        for row in csv.DictReader(f):
            d = int(row["Dialogue_ID"])
            u = int(row["Utterance_ID"])
            dia_utt_list[str(d)].append(f"dia{d}_utt{u}")
    return dia_utt_list


def truncate_seq_pair(tokens: List[List[str]], max_length: int) -> List[List[str]]:
    """Greedy longest-first truncation, one token at a time (reference :22-46).
    Mutates and returns `tokens` (list of per-utterance token lists)."""
    while True:
        lens = [(i, len(t)) for i, t in enumerate(tokens)]
        if sum(l for _, l in lens) <= max_length:
            return tokens
        # ties: reference takes sorted(reverse=True)[0] -> first index with max
        # length (stable sort); python max() has the same tie behavior
        longest = max(lens, key=lambda x: x[1])
        if longest[1] == 0:  # degenerate budget (< num utterances): stop
            return tokens
        tokens[longest[0]].pop()


@dataclass
class InputFeatures:
    """Per-dialogue padded arrays (reference :48-54)."""

    input_ids: List[int]
    input_mask: List[int]
    sep_mask: List[int]


def join_dialogue(utt_tokens: Sequence[List[str]], is_roberta: bool):
    """Join tokenized utterances with the reference's separator layout
    (reference :97-112).  Returns (tokens, sep_mask)."""
    tokens: List[str] = []
    sep_mask: List[int] = []
    for num, tu in enumerate(utt_tokens):
        if num == 0:
            if is_roberta:
                tokens = ["<s>"] + list(tu) + ["</s>"]
            else:
                tokens = ["[CLS]"] + list(tu) + ["[SEP]"]
            sep_mask = [0] * (len(tokens) - 1) + [1]
        else:
            if is_roberta:
                tokens += ["</s>"] + list(tu) + ["</s>"]
                sep_mask += [0] * (len(tu) + 1) + [1]
            else:
                tokens += list(tu) + ["[SEP]"]
                sep_mask += [0] * len(tu) + [1]
    return tokens, sep_mask


class MeldTextPreprocessor:
    """Tokenize every dialogue of a split into fixed (num_dia, 512) arrays."""

    def __init__(self, tokenizer, is_roberta: bool,
                 max_seq_length: int = MAX_SEQ_LENGTH):
        self.tokenizer = tokenizer
        self.is_roberta = is_roberta
        self.max_seq_length = max_seq_length
        # reference budgets: 512-34*2 roberta, 512-34 bert (reference :92-95);
        # clamped for small test configs where the fixed offsets don't fit
        self.budget = max(max_seq_length - (34 * 2 if is_roberta else 34),
                          max_seq_length // 2)

    def preprocess_dialogues(
            self, dialogues: Sequence[Sequence[str]]) -> List[InputFeatures]:
        """dialogues: list of utterance-text lists, one per dialogue."""
        features = []
        for utts in dialogues:
            toks = [list(self.tokenizer.tokenize(u)) for u in utts]
            toks = truncate_seq_pair(toks, self.budget)
            tokens, sep_mask = join_dialogue(toks, self.is_roberta)
            ids = list(self.tokenizer.convert_tokens_to_ids(tokens))
            input_mask = [1] * len(ids)
            pad = [0] * (self.max_seq_length - len(ids))
            features.append(InputFeatures(ids + pad, input_mask + pad,
                                          sep_mask + pad))
        return features

    def preprocess_split(self, csv_path: str, text_json_path: str):
        """Full reference flow (reference :65-130): CSV dialogue map + text json
        -> per-dialogue InputFeatures."""
        int2name = make_text_dia(csv_path)
        with open(text_json_path, encoding="utf8") as f:
            load_dict = json.load(f)
        dialogues = []
        for dia_id in int2name:
            dialogues.append(
                [load_dict[utt_id]["txt"][0] for utt_id in int2name[dia_id]])
        return self.preprocess_dialogues(dialogues)

    @staticmethod
    def to_arrays(features: List[InputFeatures]):
        ids = np.asarray([f.input_ids for f in features], np.int32)
        mask = np.asarray([f.input_mask for f in features], np.int32)
        sep = np.asarray([f.sep_mask for f in features], np.int32)
        return ids, mask, sep
