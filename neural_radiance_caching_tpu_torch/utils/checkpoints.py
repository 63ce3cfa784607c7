"""Checkpoints under numbered step directories (counterpart of
``utils/checkpoints.py``).

A checkpoint is ``checkpoint_<step>/state.pt``: ``torch.save`` of a dict
with the step, the model's state_dict, the optimizer's state and whether the
model is a material model (which the partial restores need to name its
parameters). Each step is written into a temporary directory that is
renamed into place when complete, so a reader never sees a half-written
step; with ``blocking=False`` the write runs on a background thread after
the tensors are copied to the host, and any later save or read waits for
it first.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional

import torch

_pending_save: Optional[threading.Thread] = None
_pending_lock = threading.Lock()
_STEP_DIR = re.compile(r"checkpoint_(\d+)")


def wait_for_pending_save():
    """Block until the last non-blocking save finished writing."""
    global _pending_save
    with _pending_lock:
        t, _pending_save = _pending_save, None
    if t is not None:
        t.join()


def _step_dir(checkpoint_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir, f"checkpoint_{step}")


def _steps(checkpoint_dir):
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_DIR.fullmatch, os.listdir(checkpoint_dir))
                  if m and os.path.isdir(os.path.join(checkpoint_dir, m.group(0))))


def latest_checkpoint_step(checkpoint_dir: str) -> Optional[int]:
    wait_for_pending_save()
    steps = _steps(checkpoint_dir)
    return steps[-1] if steps else None


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(checkpoint_dir: str, state: Any, step: int, keep: int = 3,
                    blocking: bool = True):
    """Save `state` (a dict of tensors and plain values) as step `step`,
    keeping the newest `keep` steps. blocking=False returns once the tensors
    are on the host and writes on a background thread."""
    global _pending_save
    wait_for_pending_save()
    os.makedirs(checkpoint_dir, exist_ok=True)
    state = _to_host(state)

    def write():
        path = _step_dir(checkpoint_dir, step)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        for s in _steps(checkpoint_dir)[:-keep]:
            shutil.rmtree(_step_dir(checkpoint_dir, s), ignore_errors=True)

    if blocking:
        write()
        return
    t = threading.Thread(target=write, name=f"ckpt-save-{step}", daemon=True)
    with _pending_lock:
        _pending_save = t
    t.start()


def load_params(checkpoint_dir: str) -> Optional[Any]:
    """The latest checkpoint's saved dict (on the CPU), or None."""
    step = latest_checkpoint_step(checkpoint_dir)
    if step is None:
        return None
    return torch.load(os.path.join(_step_dir(checkpoint_dir, step), "state.pt"),
                      map_location="cpu", weights_only=False)
