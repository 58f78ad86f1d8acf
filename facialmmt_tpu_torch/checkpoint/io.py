"""Training checkpoints on disk: resume files and best-model files
(counterpart of facialmmt_tpu/checkpoint/orbax_io.py, on torch files).

A checkpoint is one file written by `torch.save` of a plain nested dict of
tensors, numbers and strings (no pickled module or class), read back with
`torch.load(weights_only=True)` onto the CPU.  In the manager's directory:
  * `step_<n>`: the resume checkpoint after n completed epochs (or the
    mid-epoch state of epoch n + 1, written on preemption); the newest
    `keep_steps` are kept;
  * `best_<epoch>`: the model of the best validation F1 so far; a new best
    deletes every superseded `best_<int>`;
  * `.tmp_<tag>`: a file being written, renamed into place only when complete.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import torch


def _steps(directory: str, prefix: str) -> List[int]:
    """The n of every `<prefix>_<n>` file in `directory`; other entries (a
    stray `best_model_notes.txt`, a directory) are not the manager's."""
    found = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if not name.startswith(prefix + "_"):
                continue
            try:
                step = int(name[len(prefix) + 1:])
            except ValueError:
                continue
            if os.path.isfile(os.path.join(directory, name)):
                found.append(step)
    return sorted(found)


class CheckpointManager:
    """Crash-safe saves, best-model retention and newest-first restore."""

    def __init__(self, directory: str, keep_steps: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # resume checkpoints kept, newest first: only the newest is restored,
        # the one before it is insurance against a newest that fails to load.
        # <= 0 keeps every one.
        self.keep_steps = keep_steps

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def save(self, tag: str, tree: Any) -> str:
        """Write `tree` under `tag` crash-safely: into `.tmp_<tag>` first,
        then `os.replace` onto the tag, so a kill during the write (a grace
        window that runs out while a multi-GB state is written) leaves the
        previous file under that tag intact."""
        path = self._path(tag)
        tmp = self._path(f".tmp_{tag}")
        with open(tmp, "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def save_best(self, tree: Any, step: int) -> str:
        """Save a new best model and delete every superseded `best_<int>`,
        found by scanning the directory: a resumed run starts with a fresh
        manager and must remove the best of the run before the
        interruption too."""
        path = self.save(f"best_{step}", tree)
        for old in _steps(self.directory, "best"):
            if old != step:
                os.remove(self._path(f"best_{old}"))
        return path

    def save_step(self, tree: Any, step: int) -> str:
        """Save the resume checkpoint `step_<step>` and prune to the newest
        `keep_steps`."""
        path = self.save(f"step_{step}", tree)
        if self.keep_steps > 0:
            for old in _steps(self.directory, "step")[:-self.keep_steps]:
                os.remove(self._path(f"step_{old}"))
        return path

    def restore(self, tag: str) -> Any:
        return torch.load(self._path(tag), map_location="cpu",
                          weights_only=True)

    def restore_best(self) -> tuple:
        """(step, tree) of the HIGHEST-step best file: normally there is one,
        but a run killed between a resume and its first new best leaves two."""
        steps = _steps(self.directory, "best")
        if not steps:
            raise FileNotFoundError(f"no best checkpoint in {self.directory}")
        return steps[-1], self.restore(f"best_{steps[-1]}")

    def restore_latest(self) -> Optional[Any]:
        """The newest resume checkpoint, falling back to the next-newest when
        it fails to load (corrupted outside the crash-safe swap: what
        `keep_steps` > 1 keeps them for).  None when there is none; the
        newest file's error when every one fails."""
        first_err: Optional[Exception] = None
        for step in reversed(_steps(self.directory, "step")):
            try:
                return self.restore(f"step_{step}")
            except Exception as e:  # try the next-newest retained checkpoint
                first_err = first_err or e
                print(f"WARNING: restore of step_{step} failed "
                      f"({type(e).__name__}: {e}); trying an older resume "
                      f"checkpoint")
        if first_err is not None:
            raise first_err
        return None
