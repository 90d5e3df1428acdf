"""Intra-die bus architecture models: shared bus vs H-tree (Sec. III-C, Fig. 7-9).

Execution model of one MVM ``(1,M) x (M,N)`` on ``planes`` PIM planes of one
die group:

* A weight tile is ``tile_rows x tile_cols`` (128 x N_col/4 for Size A).
  ``R = ceil(M/tile_rows)`` row tiles, ``C = ceil(N/tile_cols)`` col tiles.
* **Shared bus** (conventional, Fig. 7a): planes compute in parallel but every
  partial-output vector must cross the single die bus; row-tile partials can
  only be merged (a) locally, by a plane executing ``g`` row tiles
  sequentially and accumulating in its shift-adder/page buffer, or (b) at the
  die/channel controller after crossing the bus.  We search over ``g``.
* **H-tree** (proposed, Fig. 7b): planes are leaves of a binary tree whose
  internal RPUs (ALU mode) add partials pairwise on the way out, so only the
  *unique* output columns exit the die; the tree streams INT16 vectors at 8
  lanes/cycle @250 MHz per level.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.pim import params as P
from repro_torch.core.pim import latency as lmod
from repro_torch.core.pim.params import PlaneConfig


def tree_depth(leaves: int) -> int:
    """Levels of a binary reduction tree over ``leaves`` nodes.

    Shared ruler between the analytical die model (``htree_time`` charges
    ``depth * level_lat``) and the SPMD collective
    (``repro.dist.collectives.htree_allreduce`` issues ``depth`` up-sweep
    rounds) so the two never drift apart.
    """
    return max(1, math.ceil(math.log2(max(1, leaves))))


@dataclasses.dataclass(frozen=True)
class MvmTiming:
    t_in: float          # inbound I/O (input vector broadcast)
    t_pim: float         # array compute (all waves)
    t_tree: float        # H-tree traversal latency (0 for shared bus)
    t_out: float         # outbound I/O on the die bus
    t_cmd: float         # command/sync overhead
    g: int = 1           # sequential row tiles per plane (local accumulation)
    waves: int = 1

    @property
    def total(self) -> float:
        return self.t_in + self.t_pim + self.t_tree + self.t_out + self.t_cmd


def _tiles(m: int, n: int, cfg: PlaneConfig) -> tuple[int, int]:
    return math.ceil(m / cfg.tile_rows), math.ceil(n / cfg.tile_cols)


def _out_bytes_per_tile(cfg: PlaneConfig) -> int:
    return cfg.tile_cols * 2  # INT16 partial sums


def shared_bus_time(m: int, n: int, planes: int, cfg: PlaneConfig,
                    b_input: int = P.A_BITS) -> MvmTiming:
    """Best shared-bus schedule, searching local-accumulation depth ``g``."""
    r_tiles, c_tiles = _tiles(m, n, cfg)
    t_pim1 = lmod.t_pim(cfg, b_input)
    best: MvmTiming | None = None
    for g in range(1, r_tiles + 1):
        partials = math.ceil(r_tiles / g)          # bus-crossing partials per col tile
        planes_needed = partials * c_tiles
        waves = math.ceil(planes_needed / planes)
        t = MvmTiming(
            t_in=m / P.FLASH_BUS_BPS,
            t_pim=g * waves * t_pim1,
            t_tree=0.0,
            t_out=partials * c_tiles * _out_bytes_per_tile(cfg) / P.FLASH_BUS_BPS,
            t_cmd=P.CMD_OVERHEAD_S,
            g=g,
            waves=waves,
        )
        if best is None or t.total < best.total:
            best = t
    assert best is not None
    return best


def htree_time(m: int, n: int, planes: int, cfg: PlaneConfig,
               b_input: int = P.A_BITS) -> MvmTiming:
    """H-tree schedule: in-tree pairwise accumulation, unique outputs exit."""
    r_tiles, c_tiles = _tiles(m, n, cfg)
    ops = r_tiles * c_tiles
    waves = math.ceil(ops / planes)
    depth = tree_depth(planes)
    # per-level streaming latency of one tile vector through an RPU
    level_lat = cfg.tile_cols / P.RPU_MACS_PER_CYCLE / P.RPU_CLOCK_HZ
    return MvmTiming(
        t_in=m / P.FLASH_BUS_BPS,
        t_pim=waves * lmod.t_pim(cfg, b_input),
        t_tree=depth * level_lat,
        t_out=n * 2 / P.FLASH_BUS_BPS,   # unique INT16 outputs only
        t_cmd=P.CMD_OVERHEAD_S,
        waves=waves,
    )


def fig9a_cases() -> list[tuple[str, MvmTiming, MvmTiming]]:
    """The paper's three MVMs on 64 Size-A planes: shared vs H-tree."""
    from repro_torch.core.pim.params import SIZE_A
    cases = [("1Kx1K", 1024, 1024), ("1Kx4K", 1024, 4096), ("4Kx1K", 4096, 1024)]
    return [
        (name, shared_bus_time(m, n, 64, SIZE_A), htree_time(m, n, 64, SIZE_A))
        for name, m, n in cases
    ]


def fig9b_cases() -> list[tuple[str, MvmTiming, MvmTiming]]:
    """Size A (64 planes) vs Size B (128 planes) with H-tree — iso-throughput
    (same number of active BLs per cycle), Fig. 9b."""
    from repro_torch.core.pim.params import SIZE_A, SIZE_B
    cases = [("1Kx1K", 1024, 1024), ("1Kx4K", 1024, 4096), ("4Kx1K", 4096, 1024)]
    return [
        (name, htree_time(m, n, 64, SIZE_A), htree_time(m, n, 128, SIZE_B))
        for name, m, n in cases
    ]
