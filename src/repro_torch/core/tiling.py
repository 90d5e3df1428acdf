"""Hierarchical tiling & mapping of static-MVMs (Sec. IV-B, Fig. 11-12).

The flash hierarchy has 4 levels (channel, way, die, plane).  At each level a
weight matrix may be tiled **row-wise** (``R``: scatter input rows, partial
outputs must be *accumulated*), **column-wise** (``C``: broadcast input,
outputs are *concatenated*), or not tiled (``N``: count = 1).  A tiling
config assigns a (method, count) to every level such that the products of the
row / column counts cover ``ceil(M/tile_rows)`` x ``ceil(N/tile_cols)`` unit
tiles (the unit tile is ``u x N_col/4``, Sec. IV-B).

Cost model (3-stage pipeline: inbound I/O || PIM, then H-tree, outbound):

* inbound  — the input vector is broadcast on every channel bus in parallel,
  so it is *identical across tilings* (Fig. 12's observation).
* PIM      — ``waves x T_PIM`` with ``waves = ceil(ops / planes_used)``.
* outbound — partial outputs tiled row-wise at the *plane* level are merged
  inside the die by the H-tree (RPU ALU mode) and never cross the bus;
  row-wise partials created at the way/die/channel level each cross the
  channel bus once and merge in the controller.  Column tiles at the channel
  level divide the per-channel output bytes (the paper's key finding).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

from repro_torch.core.pim import params as P
from repro_torch.core.pim import latency as lmod
from repro_torch.core.pim.params import PlaneConfig, SIZE_A

LEVELS = ("channel", "way", "die", "plane")


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    channel: int = P.N_CHANNELS
    way: int = P.N_WAYS
    die: int = P.N_QLC_DIES          # QLC dies hold sMVM weights (Sec. IV-A)
    plane: int = P.PLANES_PER_DIE

    def size(self, level: str) -> int:
        return getattr(self, level)


@dataclasses.dataclass(frozen=True)
class TilingConfig:
    methods: tuple[str, str, str, str]   # per LEVELS, in ('N','C','R')
    counts: tuple[int, int, int, int]

    @property
    def label(self) -> str:
        return "/".join(self.methods)

    def count(self, level: str) -> int:
        return self.counts[LEVELS.index(level)]

    def method(self, level: str) -> str:
        return self.methods[LEVELS.index(level)]


@dataclasses.dataclass(frozen=True)
class TilingCost:
    config: TilingConfig
    t_in: float
    t_pim: float
    t_tree: float
    t_out: float
    t_cmd: float

    @property
    def total(self) -> float:
        # inbound overlaps PIM (Sec. V-A: "the first two overlap")
        return max(self.t_in, self.t_pim) + self.t_tree + self.t_out + self.t_cmd


def _cover_splits(total: int, size: int) -> list[int]:
    """Candidate per-level counts (1..size) that could divide a cover of total."""
    return sorted({min(size, c) for c in range(1, size + 1)})


def evaluate(cfg: TilingConfig, m: int, n: int, hier: Hierarchy,
             plane_cfg: PlaneConfig = SIZE_A, htree: bool = True,
             b_input: int = P.A_BITS) -> TilingCost | None:
    r_tiles = math.ceil(m / plane_cfg.tile_rows)
    c_tiles = math.ceil(n / plane_cfg.tile_cols)

    prod_r = prod_c = 1
    for meth, cnt, lvl in zip(cfg.methods, cfg.counts, LEVELS):
        if cnt < 1 or cnt > hier.size(lvl):
            return None
        if meth == "N" and cnt != 1:
            return None
        if meth == "R":
            prod_r *= cnt
        elif meth == "C":
            prod_c *= cnt
    if prod_r < 1 or prod_c < 1:
        return None
    # the tile-count products must cover the unit-tile grid (Sec. IV-B)
    if prod_r * prod_c < r_tiles * c_tiles and (prod_r < r_tiles or prod_c < c_tiles):
        pass  # allowed: remaining tiles execute in extra waves
    ops = r_tiles * c_tiles
    planes_used = max(1, min(prod_r * prod_c, ops))
    waves = math.ceil(ops / planes_used)

    t_in = m / P.FLASH_BUS_BPS                      # broadcast, all channels parallel
    t_pim = waves * lmod.t_pim(plane_cfg, b_input)

    # --- outbound ---------------------------------------------------------
    tile_out = plane_cfg.tile_cols * 2              # INT16
    ch_cnt = cfg.count("channel") if cfg.method("channel") == "C" else 1
    cols_per_ch = math.ceil(c_tiles / ch_cnt)
    # row partials that cross the channel bus: R splits above the plane level
    crossing = 1
    for lvl in ("channel", "way", "die"):
        if cfg.method(lvl) == "R":
            crossing *= cfg.count(lvl)
    # plane-level row tiles: merged by H-tree inside the die (free) if enabled,
    # otherwise every plane partial crosses the bus (shared-bus behaviour).
    plane_r = cfg.count("plane") if cfg.method("plane") == "R" else 1
    residual_r = math.ceil(r_tiles / max(1, crossing * plane_r))
    if htree:
        per_die_partials = 1
        depth = max(1, math.ceil(math.log2(max(2, cfg.count("plane")))))
        t_tree = depth * plane_cfg.tile_cols / P.RPU_MACS_PER_CYCLE / P.RPU_CLOCK_HZ
    else:
        per_die_partials = plane_r
        t_tree = 0.0
    bytes_per_ch = cols_per_ch * tile_out * crossing * per_die_partials * residual_r
    t_out = bytes_per_ch / P.FLASH_BUS_BPS

    return TilingCost(cfg, t_in=t_in, t_pim=t_pim, t_tree=t_tree, t_out=t_out,
                      t_cmd=P.CMD_OVERHEAD_S)


def enumerate_configs(m: int, n: int, hier: Hierarchy,
                      plane_cfg: PlaneConfig = SIZE_A) -> list[TilingConfig]:
    """All (method, count) combos; counts restricted to divisor-ish covers."""
    r_tiles = math.ceil(m / plane_cfg.tile_rows)
    c_tiles = math.ceil(n / plane_cfg.tile_cols)
    out = []
    for methods in itertools.product("NCR", repeat=4):
        per_level = []
        for meth, lvl in zip(methods, LEVELS):
            if meth == "N":
                per_level.append([1])
            else:
                need = r_tiles if meth == "R" else c_tiles
                size = hier.size(lvl)
                cands = sorted({min(size, need), *(c for c in (2, 4, 7, 8, 14, 16, 28, 56)
                                                   if c <= size and c <= need)})
                per_level.append(cands or [1])
        for counts in itertools.product(*per_level):
            out.append(TilingConfig(methods=tuple(methods), counts=tuple(counts)))
    return out


def search(m: int, n: int, hier: Hierarchy | None = None,
           plane_cfg: PlaneConfig = SIZE_A, htree: bool = True,
           top_k: int = 10) -> list[TilingCost]:
    """Rank tiling configs by total latency (the paper's in-house search)."""
    hier = hier or Hierarchy()
    costs = []
    for cfg in enumerate_configs(m, n, hier, plane_cfg):
        c = evaluate(cfg, m, n, hier, plane_cfg, htree=htree)
        if c is not None:
            costs.append(c)
    costs.sort(key=lambda c: (c.total, c.config.counts))
    # deduplicate by label keeping the best counts per label
    seen, uniq = set(), []
    for c in costs:
        if c.config.label not in seen:
            seen.add(c.config.label)
            uniq.append(c)
    return uniq[:top_k]


def fig12_cases(d_model: int = 7168) -> dict[str, TilingCost]:
    """The paper's three reported cases for OPT-30B's (d_m x d_m) sMVM."""
    hier = Hierarchy(die=8)  # Fig. 12 uses all 8 dies per way
    def best_for(label: str, htree: bool = True) -> TilingCost:
        methods = tuple(label.split("/"))
        cands = [evaluate(cfg, d_model, d_model, hier, SIZE_A, htree=htree)
                 for cfg in enumerate_configs(d_model, d_model, hier, SIZE_A)
                 if cfg.methods == methods]
        cands = [c for c in cands if c is not None]
        return min(cands, key=lambda c: c.total)
    return {
        "N/C/C/R": best_for("N/C/C/R"),
        "C/C/R/R": best_for("C/C/R/R"),
        "C/C/N/R": best_for("C/C/N/R"),
    }
