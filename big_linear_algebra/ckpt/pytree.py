"""Pytree checkpoints in one self-contained format (numpy ``.npz``).

Training *is* resume in the reference — ``train`` loads existing CSVs,
updates, saves on exit (model/mnist_nn.c:165-170,371-376). Here the whole
train state (params, optimizer moments, step counter, PRNG key) is one pytree
saved per step; a killed run restores the latest step and continues
(SURVEY.md §5 "Failure detection / checkpoint-resume").

Layout: ``<base_dir>/step_<n>/`` holds ``arrays.npz`` (every leaf's raw
bytes, in flatten order) and ``meta.json`` (tree structure, dtypes, shapes,
optional metrics). A step is written into a temporary directory and renamed
into place, so a crash mid-save never leaves a restorable-looking partial
step; ``latest_step`` ignores any directory without ``meta.json``.

Two layers:
- ``save_pytree``/``restore_pytree``/``latest_step``: one-shot synchronous
  save/restore with optional keep-last-k retention. Restore checks the
  structure and shapes against a target tree and casts to its dtypes.
- ``TrainCheckpointer``: asynchronous saves (the state is copied to the host,
  then a writer thread serializes it while training continues), keep-last-k
  retention, and optional best-k selection by a metric (e.g. keep the 3
  lowest-loss steps).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

_STEP_RE = re.compile(r"^step_(\d+)$")
_META = "meta.json"
_ARRAYS = "arrays.npz"


def _step_dir(base_dir: str, step: int) -> Path:
    return Path(base_dir) / f"step_{step}"


def _complete_steps(base_dir: str) -> list[int]:
    base = Path(base_dir)
    if not base.is_dir():
        return []
    return sorted(int(m.group(1)) for p in base.iterdir()
                  if (m := _STEP_RE.match(p.name)) and (p / _META).is_file())


def latest_step(base_dir: str) -> Optional[int]:
    steps = _complete_steps(base_dir)
    return steps[-1] if steps else None


def _apply_retention(base_dir: str, keep_last: int) -> None:
    for s in _complete_steps(base_dir)[:-keep_last]:
        shutil.rmtree(_step_dir(base_dir, s), ignore_errors=True)


def save_pytree(base_dir: str, step: int, tree: Any,
                keep_last: Optional[int] = None,
                metrics: Optional[dict] = None) -> None:
    """Save a pytree checkpoint at ``base_dir/step_<step>``. With
    ``keep_last=k`` only the k most recent steps are retained."""
    path = _step_dir(base_dir, step)
    leaves, treedef = jax.tree.flatten(tree)
    leaves = [np.asarray(x) for x in leaves]
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    # raw bytes as unsigned ints: npz has no bfloat16, the dtype name does
    np.savez(tmp / _ARRAYS, *[
        x.reshape(-1).view(f"u{x.dtype.itemsize}") for x in leaves])
    meta = {"treedef": str(treedef),
            "dtypes": [x.dtype.name for x in leaves],
            "shapes": [list(x.shape) for x in leaves],
            "metrics": metrics}
    (tmp / _META).write_text(json.dumps(meta))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)  # atomic within a filesystem
    if keep_last is not None and keep_last > 0:
        _apply_retention(base_dir, keep_last)


def _read_meta(base_dir: str, step: int) -> dict:
    return json.loads((_step_dir(base_dir, step) / _META).read_text())


def restore_pytree(base_dir: str, target: Any,
                   step: Optional[int] = None) -> Any:
    """Restore the pytree at ``step`` (default: latest). ``target`` supplies
    the structure, shapes, dtypes and placement: a checkpoint whose structure
    or shapes differ raises ``ValueError``; leaves are cast to the target's
    dtypes and put on the target leaves' shardings."""
    if step is None:
        step = latest_step(base_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base_dir}")
    meta = _read_meta(base_dir, step)
    flat, treedef = jax.tree.flatten(target)
    if meta["treedef"] != str(treedef):
        raise ValueError(f"step {step} under {base_dir} has another tree "
                         f"structure than the restore target")
    out = []
    with np.load(_step_dir(base_dir, step) / _ARRAYS) as data:
        for i, (t, dtype, shape) in enumerate(
                zip(flat, meta["dtypes"], meta["shapes"])):
            if tuple(shape) != tuple(np.shape(t)):
                raise ValueError(
                    f"leaf {i} of step {step}: saved shape {tuple(shape)}, "
                    f"target shape {tuple(np.shape(t))}")
            x = data[f"arr_{i}"].view(jnp.dtype(dtype)).reshape(shape)
            x = x.astype(jnp.dtype(getattr(t, "dtype", x.dtype)))
            if isinstance(t, jax.Array):
                x = jax.device_put(x, t.sharding)
            out.append(x)
    return jax.tree.unflatten(treedef, out)


class TrainCheckpointer:
    """Asynchronous checkpoint writer with retention / best-k selection.

    - ``max_to_keep``: retain at most k steps (oldest dropped first);
      ``None`` keeps every step.
    - ``best_metric``/``best_mode``: when set (e.g. ``"loss"``/``"min"``),
      retention keeps the k *best* steps by that metric instead of the k
      most recent — pass the metric value to ``save(..., metrics={...})``.
      Steps saved without that metric are not kept.
    - saves are asynchronous: ``save`` copies the state to the host and
      returns; a writer thread serializes it while training continues. One
      save is in flight at a time. Call ``wait()`` before reading the files
      (``close`` does).

    Uses the same ``step_<n>`` layout as ``save_pytree``.
    """

    def __init__(self, base_dir: str, max_to_keep: Optional[int] = 3,
                 best_metric: Optional[str] = None, best_mode: str = "min",
                 async_saves: bool = True):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be min or max, got {best_mode!r}")
        self._base = str(base_dir)
        self._keep = max_to_keep
        self._metric = best_metric
        self._mode = best_mode
        self._async = async_saves
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, metrics: Optional[dict] = None):
        self.wait()
        # copy to the host now: the caller may donate these buffers to the
        # next step as soon as this returns
        host = jax.device_get(tree)
        if not self._async:
            self._write(step, host, metrics)
            return
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host, metrics),
            daemon=True)
        self._thread.start()

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # re-raised in the caller by wait()
            self._error = e

    def _write(self, step, host, metrics):
        save_pytree(self._base, step, host, metrics=metrics)
        self._retain()

    def _retain(self):
        if not self._keep:
            return
        steps = _complete_steps(self._base)
        if self._metric is None:
            keep = set(steps[-self._keep:])
        else:
            scored = []
            for s in steps:
                m = _read_meta(self._base, s).get("metrics") or {}
                if self._metric in m:
                    scored.append((float(m[self._metric]), s))
            scored.sort(reverse=self._mode == "max")
            keep = {s for _, s in scored[:self._keep]}
        for s in steps:
            if s not in keep:
                shutil.rmtree(_step_dir(self._base, s), ignore_errors=True)

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        self.wait()
        return restore_pytree(self._base, target, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self._base)

    def all_steps(self):
        return _complete_steps(self._base)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
