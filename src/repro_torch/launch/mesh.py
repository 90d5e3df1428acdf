"""Device meshes over ``torch.distributed`` process groups.

PyTorch counterpart of ``repro.launch.mesh``.  A mesh here is a grid of
processes (ranks), not of devices: rank ``r`` sits at the row-major
coordinates of ``r`` over the mesh's axes, and each subset of the axes
partitions the world into process groups (the ranks that agree on every
other axis).  The collectives (``dist/collectives.py``) run over those
groups with gloo, through host memory, so ranks may share one card: NCCL
refuses two ranks on one GPU.  The process group must be initialized
before a mesh is made (:func:`spawn` does it); every rank makes the same
groups in the same order, as ``torch.distributed.new_group`` requires.

A :class:`CountingMesh` is a mesh of any shape seen from one chosen rank
in one process, with no process group: its collectives take ``meta``
tensors, return the shapes the real calls would and count their bytes
(``dist/collectives.py``).  The dry run counts the production meshes
(:func:`make_production_mesh`) and the quick 2x4 mesh so.
"""
from __future__ import annotations

import datetime
import itertools
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


class AxisGroup:
    """The ranks of one process group of a mesh: ``ranks`` (global, in
    row-major order over the group's axes), this rank's place ``index`` in
    them, and the gloo group (``None`` for a group of one rank, and for
    every group of a :class:`CountingMesh`, whose groups are
    ``counting``)."""

    def __init__(self, axes: tuple[str, ...], ranks: list[int], index: int, pg,
                 counting: bool = False):
        self.axes, self.ranks, self.index, self.pg = axes, ranks, index, pg
        self.counting = counting

    @property
    def size(self) -> int:
        return len(self.ranks)


class AbstractMesh:
    """A mesh's shape alone (``axis_names``, ``shape[axis]``), with no
    process group: what the spec builders of ``dist/sharding.py`` read, so
    they can run for any mesh in one process."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in rank")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))


class Mesh:
    """A ``shape`` grid of ranks named ``axis_names`` (rank ``r`` at the
    row-major coordinates of ``r``), over the initialized default process
    group: ``shape[axis]`` its size, :meth:`group` the process group of
    this rank over some axes, :meth:`index` this rank's coordinate along
    them."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs an initialized torch.distributed "
                               "process group (see launch.mesh.spawn)")
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in rank")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        n = 1
        for s in shape:
            n *= s
        if n != self.world:
            raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {n} processes, "
                             f"have {self.world}")
        self._groups: dict[tuple[str, ...], AxisGroup] = {}
        # every subset of the axes, every group of each: made on every rank
        # in the same order
        for k in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, k):
                self._make_groups(axes)

    def _make_groups(self, axes: tuple[str, ...]) -> None:
        others = [a for a in self.axis_names if a not in axes]
        dims = [self.shape[a] for a in self.axis_names]
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            pin = dict(zip(others, fixed))
            ranks = []
            for inner in itertools.product(*(range(self.shape[a]) for a in axes)):
                c = dict(pin, **dict(zip(axes, inner)))
                ranks.append(_ravel([c[a] for a in self.axis_names], dims))
            pg = dist.new_group(ranks, backend="gloo") if len(ranks) > 1 else None
            if self.rank in ranks:
                self._groups[axes] = AxisGroup(axes, ranks, ranks.index(self.rank), pg)

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)    # mesh order

    def group(self, axes) -> AxisGroup:
        """This rank's group over ``axes`` (a name or a tuple of names)."""
        axes = self._axes(axes)
        if not axes:
            return AxisGroup((), [self.rank], 0, None)
        return self._groups[axes]

    def index(self, axes) -> int:
        """This rank's row-major coordinate over ``axes``."""
        return self.group(axes).index

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={self.shape[a]}" for a in self.axis_names)
        return f"Mesh({dims}; rank {self.rank})"


def _ravel(coords, dims) -> int:
    r = 0
    for c, d in zip(coords, dims):
        r = r * d + c
    return r


class CountingMesh:
    """A ``shape`` grid of ranks named ``axis_names`` seen from rank
    ``rank`` in one process, with no process group: :meth:`group` and
    :meth:`index` as :class:`Mesh` gives them to that rank, every group
    ``counting`` (its collectives take ``meta`` tensors and count the real
    calls' bytes, ``dist/collectives.py``).  It needs no world and runs
    nothing across processes."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...], rank: int = 0):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in rank")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        self.world = 1
        for s in shape:
            self.world *= s
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a mesh of {self.world}")
        self.rank = rank
        coords, r = [], rank
        for s in reversed(shape):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(axis_names, reversed(coords)))

    _axes = Mesh._axes

    def group(self, axes) -> AxisGroup:
        axes = self._axes(axes)
        dims = [self.shape[a] for a in self.axis_names]
        ranks = []
        for inner in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords, **dict(zip(axes, inner)))
            ranks.append(_ravel([c[a] for a in self.axis_names], dims))
        return AxisGroup(axes, ranks, ranks.index(self.rank), None, counting=True)

    def index(self, axes) -> int:
        return self.group(axes).index

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={self.shape[a]}" for a in self.axis_names)
        return f"CountingMesh({dims}; rank {self.rank})"


def make_local_mesh(d: int, m: int) -> Mesh:
    """A (data, model) mesh over a world of ``d * m`` processes (serve
    ``--mesh DxM``); raises ``ValueError`` naming the count if the world
    differs."""
    return Mesh((d, m), ("data", "model"))


def make_host_mesh() -> Mesh:
    """Every process of the world as a (1, n) (data, model) mesh."""
    return Mesh((1, dist.get_world_size()), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> CountingMesh:
    """The production mesh, (16, 16) (data, model) or (2, 16, 16) (pod,
    data, model), as a :class:`CountingMesh` seen from ``rank``: a world
    of 256 or 512 processes does not run on one card, so the dry run counts
    one rank's collectives on ``meta``."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return CountingMesh(shape, axes, rank)


def make_quick_mesh(rank: int = 0) -> CountingMesh:
    """The reference dry run's ``--quick`` 2x4 (data, model) mesh, counted
    from ``rank``."""
    return CountingMesh((2, 4), ("data", "model"), rank)


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"DxM"`` -> (D, M)."""
    try:
        d, m = (int(s) for s in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants DxM (e.g. 2x4), got {spec!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec}: both sizes must be >= 1")
    return d, m


# ---------------------------------------------------------------------------
# spawning a world
# ---------------------------------------------------------------------------
def _rank_main(rank: int, world: int, store_path: str, out_dir: str, threads: int,
               timeout_s: float, fn: Callable, args: tuple) -> None:
    torch.set_num_threads(threads)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result, err = fn(rank, *args), None
    except BaseException as e:                   # noqa: BLE001
        result, err = None, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((result, err), f)
    if err is None:
        dist.barrier()
        dist.destroy_process_group()
    else:
        # a failed rank does not wait for the others: they fail in their
        # next collective, or finish and report
        os._exit(1)


class World:
    """``world`` processes started by :func:`start`, running ``fn(rank,
    *args)`` in a gloo world with a rendezvous of their own (a
    ``FileStore`` in a fresh temp directory, so several worlds may run at
    once); :meth:`join` waits for them."""

    def __init__(self, fn: Callable, world: int, args: tuple, threads: int,
                 timeout_s: float):
        ctx = torch.multiprocessing.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="mesh_world_")
        store_path = os.path.join(self._tmp.name, "store")
        self.timeout_s = timeout_s
        self.procs = [ctx.Process(target=_rank_main, daemon=False,
                                  args=(r, world, store_path, self._tmp.name, threads,
                                        timeout_s, fn, args))
                      for r in range(world)]
        self.t0 = time.monotonic()
        for p in self.procs:
            p.start()

    def join(self) -> list[Any]:
        """Each rank's result in rank order (``fn`` and its result must
        pickle).  Any rank that raises, dies or outlives the timeout raises
        here with its error; every process has ended when this returns."""
        procs, tmp = self.procs, self._tmp.name
        deadline = self.t0 + self.timeout_s
        try:
            # a rank that failed ends the world: the others would wait in
            # their next collective until gloo's timeout
            while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
                   and not any(p.exitcode not in (None, 0) for p in procs)):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        try:
            results, errors = [], []
            for r, p in enumerate(procs):
                path = os.path.join(tmp, f"rank{r}.pkl")
                if not os.path.exists(path):
                    errors.append(f"rank {r}: exited with {p.exitcode} and no result")
                    continue
                with open(path, "rb") as f:
                    res, err = pickle.load(f)
                if err is not None:
                    errors.append(f"rank {r}: {err}")
                elif p.exitcode != 0:
                    errors.append(f"rank {r}: exit code {p.exitcode}")
                results.append(res)
            if errors:
                raise RuntimeError("mesh world failed:\n" + "\n".join(errors))
            return results
        finally:
            self._tmp.cleanup()


def start(fn: Callable, world: int, *args, threads: int = 1,
          timeout_s: float = 600.0) -> World:
    """Start ``fn(rank, *args)`` in ``world`` new processes joined in a gloo
    world (``threads`` torch threads each) and return at once."""
    return World(fn, world, args, threads, timeout_s)


def spawn(fn: Callable, world: int, *args, threads: int = 1,
          timeout_s: float = 600.0) -> list[Any]:
    """:func:`start` the world and :meth:`World.join` it."""
    return start(fn, world, *args, threads=threads, timeout_s=timeout_s).join()
