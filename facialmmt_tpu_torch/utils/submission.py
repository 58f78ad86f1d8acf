"""Competition submission and prediction-dump writers (counterpart of
facialmmt_tpu/utils/submission.py; reference (Appendix)CCAC2023/train.py:
156-194 and utils/eval_metrics.py:11-39).  Pure Python and numpy."""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np

# M3ED emotion names (reference (Appendix)CCAC2023/train.py:160)
M3ED_EMOTIONS = ("Neutral", "Surprise", "Fear", "Sad", "Happy", "Disgust",
                 "Anger")


def write_submission_csv(logits: np.ndarray, template_csv: str,
                         out_csv: str,
                         emotions: Sequence[str] = M3ED_EMOTIONS) -> None:
    """argmax logits -> emotion names filled into column 1 of the template
    (reference train.py:178-194)."""
    preds = np.asarray(logits).argmax(-1)
    with open(template_csv, newline="", encoding="utf8") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    for i in range(min(len(preds), len(body))):
        body[i][1] = emotions[int(preds[i])]
    with open(out_csv, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(body)


def write_pred_true_dump(preds: np.ndarray, truths: np.ndarray,
                         path: str) -> int:
    """'pred true' per line + correct count (reference utils/eval_metrics.py:22-35).
    Returns the number of correct predictions."""
    preds = np.asarray(preds)
    truths = np.asarray(truths)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    correct = 0
    with open(path, "w") as f:
        for p, t in zip(preds, truths):
            if p == t:
                correct += 1
            f.write(f"{int(p)} {int(t)}\n")
    return correct
