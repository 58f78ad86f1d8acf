"""Run records (counterpart of MetricWriter in
facialmmt_tpu/utils/observability.py).

MetricWriter prints the reference's progress lines (reference
train.py:36-42, 146-152) and appends the same records as JSON lines to
`--metrics_path`: one object per record with `tag` (`src_train`,
`trg_train`, `val`, `test`), `step`, `time` (Unix seconds) and the record's
numbers.  An empty path prints only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricWriter:
    def __init__(self, path: str = ""):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def write(self, tag: str, step: int, **metrics: Any):
        rec: Dict[str, Any] = {"tag": tag, "step": step,
                               "time": time.time(), **metrics}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        return rec

    def log_train(self, task: str, epoch: int, batch: int, num_batches: int,
                  ms_per_batch: float, loss: float):
        """Reference-format train line (reference train.py:39-40, 149-150)."""
        print(f"**{task}** | Epoch {epoch:2d} | Batch {batch:3d}/"
              f"{num_batches:3d} | Time/Batch(ms) {ms_per_batch:5.2f} | "
              f"Train Loss {loss:5.4f}")
        self.write(f"{task.lower()}_train", batch, epoch=epoch,
                   ms_per_batch=ms_per_batch, loss=loss)

    def log_eval(self, epoch: int, hours: float, val_f1: float):
        print("-" * 50)
        print(f"**TRG** | Epoch {epoch:2d} | Time {hours:5.4f} hour | "
              f"val_wg_av_f1 {val_f1:5.4f} ")
        print("-" * 50)
        self.write("val", epoch, wf1=val_f1, hours=hours)

    def log_test(self, wf1: float):
        print(f"**TEST** | wg_av_f1 {wf1:5.4f} ")
        self.write("test", 0, wf1=wf1)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
