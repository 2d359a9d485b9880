"""Step-indexed checkpoints in plain torch files (the port of
videoswap_tpu/utils/checkpointing.py, which is orbax's manager), behind
the train CLI's `logger.checkpoint_backend: orbax`.

- each step in its own directory, `<directory>/<step>/state.pth`, written
  under a temporary name beside it and then `os.replace`d: a run killed
  mid-save leaves no half-written step (only a `<step>.tmp-*` directory,
  which no listing counts);
- retention: `max_to_keep` pruning, the oldest steps first;
- loads with `torch.load(weights_only=True)`: tensors, numbers, strings
  and their dicts, lists and tuples (a model's and an optimizer's
  `state_dict`), nothing that unpickling would run.

Saves are synchronous: orbax's background-thread saves and its sharded
restore have no counterpart on one card. `CheckpointManager` is for the
training loop; `save_pytree` and `restore_pytree` are the one-shots.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import torch

STATE_FILE = 'state.pth'


def _write_dir(path: str, state: Any) -> None:
    """`state` as `path/state.pth`, the directory replaced as a whole."""
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + '.tmp-',
                           dir=parent)
    try:
        torch.save(state, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read_dir(path: str) -> Any:
    file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f'no checkpoint at {path}')
    return torch.load(file, map_location='cpu', weights_only=True)


class CheckpointManager:
    """Step-indexed checkpoints of one state (e.g. {'adapter': ...,
    'optimizer': ..., 'global_step': ...}) under `directory`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    def save(self, step: int, state: Any) -> None:
        _write_dir(os.path.join(self._dir, str(int(step))), state)
        steps = self.all_steps()
        for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(os.path.join(self._dir, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at `step` (default: the latest), tensors on the
        CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f'no checkpoint under {self._dir}')
        return _read_dir(os.path.join(self._dir, str(int(step))))

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_pytree(path: str, state: Any) -> None:
    """One-shot save of `state` to `path` (a directory)."""
    _write_dir(os.path.abspath(path), state)


def restore_pytree(path: str) -> Any:
    """One-shot restore of what `save_pytree` wrote, tensors on the CPU."""
    return _read_dir(os.path.abspath(path))
