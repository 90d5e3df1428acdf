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
:func:`restore` puts each leaf on ``device``.

On a mesh (``specs``, the tree's spec tree, and ``mesh``) the layout is the
same, one whole ``.npy`` a leaf: :func:`save` gathers each leaf from its
blocks (the ranks that hold them), rank 0 writes, and every other rank
waits until ``COMMIT`` lands; :func:`restore` reads each rank's block of
each whole leaf (``np.load(mmap_mode="r")``, then the block), onto a mesh
of any shape, the reference's elastic reshard: a checkpoint written on one
mesh restores bit for bit on another, or in one process.
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

COMMIT_WAIT_S = 600.0           # how long a rank waits for rank 0's COMMIT


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


def _whole(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor leaf of a rank's ``tree`` gathered whole from its blocks
    under ``specs`` (a tree of the same structure, a spec at each tensor)."""
    from repro_torch.dist import sharding as SH
    if isinstance(tree, dict):
        return {k: _whole(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_whole(v, sp, mesh) for v, sp in zip(tree, specs)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)
    if isinstance(tree, torch.Tensor):
        return SH.unshard(tree, specs, mesh)
    return tree


def _wait_commit(final: Path, timeout_s: float = COMMIT_WAIT_S) -> None:
    t0 = time.monotonic()
    while not (final / "COMMIT").exists():
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"no COMMIT in {final} after {timeout_s} s")
        time.sleep(0.01)


def save(ckpt_dir: str | Path, step: int, tree: Any, extra: dict | None = None,
         specs: Any = None, mesh=None) -> Path:
    """Synchronous atomic checkpoint; on a mesh (``specs`` the tree's spec
    tree) every rank passes its blocks, rank 0 writes the whole leaves and
    the others return once its ``COMMIT`` has landed."""
    if mesh is not None:
        whole = _whole(tree, specs, mesh)
        final = Path(ckpt_dir) / f"step_{step}"
        if mesh.rank == 0:
            return save(ckpt_dir, step, whole, extra)
        _wait_commit(final)
        return final
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
            device: str | torch.device | None = None, specs: Any = None,
            mesh=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` -> (tree, extra).  Each leaf
    becomes a tensor on ``device``, by default on the device of ``like``'s
    leaf there (the CPU for a leaf that is not a tensor).  On a mesh
    (``specs``: the spec tree of the rank's tree, any mesh shape) each leaf
    is the rank's block of the whole leaf, read from the memory-mapped
    file."""
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
        if mesh is not None:
            arr = np.load(d / manifest["leaves"][key]["file"], mmap_mode="r")
            arr = np.array(_block(arr, _spec_at(specs, path), mesh))
        else:
            arr = np.load(d / manifest["leaves"][key]["file"])
        to = dev if dev is not None else (leaf.device if isinstance(leaf, torch.Tensor)
                                          else torch.device("cpu"))
        leaves[key] = torch.from_numpy(arr).to(to)
    return _rebuild(like, leaves), manifest["extra"]


def _spec_at(specs: Any, path: tuple):
    """The spec of the leaf at ``path`` (``_items``' names) of a spec tree."""
    node = specs
    for k in path:
        if isinstance(node, dict):
            node = node[k]
        elif hasattr(node, "_fields"):
            node = getattr(node, k)
        else:
            node = node[int(k[1:])]
    return node


def _block(arr: np.ndarray, spec, mesh) -> np.ndarray:
    from repro_torch.dist import sharding as SH
    if spec is None:
        return arr
    sl = tuple(SH.block(arr.shape[i], mesh, axes) for i, axes in enumerate(SH.live(spec, mesh)))
    return arr[sl]


class AsyncCheckpointer:
    """Background-thread writer; the step loop never blocks on I/O (only on
    the copy to host memory)."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._pending: Path | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None, specs: Any = None,
             mesh=None) -> None:
        """Copy ``tree`` to host memory and write it on a background thread;
        on a mesh every rank gathers its leaves here (the collectives run
        on the calling thread), rank 0 writes and the others' :meth:`wait`
        waits for its ``COMMIT``."""
        self.wait()
        if mesh is not None:
            tree = _whole(tree, specs, mesh)
            if mesh.rank != 0:
                self._pending = self.dir / f"step_{step}"
                return
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
        if self._pending is not None:
            pending, self._pending = self._pending, None
            _wait_commit(pending)
        if self.last_error:
            raise self.last_error

    def _gc(self) -> None:
        for s in _committed(self.dir)[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
