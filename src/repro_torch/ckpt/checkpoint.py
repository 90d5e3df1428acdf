"""Fault-tolerant checkpointing: atomic, async.

PyTorch-port counterpart of ``repro.ckpt.checkpoint``, in the same on-disk
layout: ``<dir>/step_<n>/`` holding one ``.npy`` per tree leaf (the leaf's
flattened path as the file name: dict keys, ``#i`` for a list or tuple
entry, a named tuple's field names) and ``manifest.json`` (step, extra
metadata such as the data-pipeline cursor, each leaf's file, shape and
dtype).  A checkpoint only exists once ``COMMIT`` lands: it is written
into ``.tmp_step_<n>`` and renamed, so half-written checkpoints are
invisible to :func:`restore`.  :class:`AsyncCheckpointer` copies the tree to
host memory, then writes on a background thread while training steps on.
:func:`restore` puts each leaf on ``device`` (where the reference takes
shardings; resharding onto a mesh is ROADMAP A.14b).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve


def _items(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) for every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _items(v, (*prefix, str(k)))]
    if isinstance(tree, (list, tuple)):
        names = tree._fields if hasattr(tree, "_fields") else [f"#{i}" for i in range(len(tree))]
        return [x for n, v in zip(names, tree) for x in _items(v, (*prefix, n))]
    return [(prefix, tree)]


def _key(path: tuple) -> str:
    return "/".join(path) or "root"


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a numpy array that owns its memory (a CPU tensor's array
    would share the tensor's, which a later in-place step overwrites)."""
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().cpu())
    return np.array(leaf)


def save(ckpt_dir: str | Path, step: int, tree: Any, extra: dict | None = None) -> Path:
    """Synchronous atomic checkpoint."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for path, leaf in _items(tree):
        key = _key(path)
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text(str(time.time()))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _committed(ckpt_dir: Path) -> list[int]:
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                  if (p / "COMMIT").exists())


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _committed(ckpt_dir)
    return steps[-1] if steps else None


def _rebuild(like: Any, leaves: dict, prefix: tuple = ()) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, (*prefix, str(k))) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if hasattr(like, "_fields"):
            return type(like)(*(_rebuild(v, leaves, (*prefix, n))
                                for n, v in zip(like._fields, like)))
        return type(like)(_rebuild(v, leaves, (*prefix, f"#{i}")) for i, v in enumerate(like))
    return leaves[_key(prefix)]


def restore(ckpt_dir: str | Path, like: Any, step: int | None = None,
            device: str | torch.device | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` -> (tree, extra).  Each leaf
    becomes a tensor on ``device``, by default on the device of ``like``'s
    leaf there (the CPU for a leaf that is not a tensor)."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    dev = resolve(device) if device is not None else None
    leaves = {}
    for path, leaf in _items(like):
        key = _key(path)
        arr = np.load(d / manifest["leaves"][key]["file"])
        to = dev if dev is not None else (leaf.device if isinstance(leaf, torch.Tensor)
                                          else torch.device("cpu"))
        leaves[key] = torch.from_numpy(arr).to(to)
    return _rebuild(like, leaves), manifest["extra"]


class AsyncCheckpointer:
    """Background-thread writer; the step loop never blocks on I/O (only on
    the copy to host memory)."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()
        host = [(path, _host(leaf)) for path, leaf in _items(tree)]
        host_tree = _rebuild(tree, {_key(p): a for p, a in host})

        def _work():
            try:
                save(self.dir, step, host_tree, extra)
                self._gc()
            except Exception as e:  # noqa: BLE001 - re-raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error:
            raise self.last_error

    def _gc(self) -> None:
        for s in _committed(self.dir)[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
