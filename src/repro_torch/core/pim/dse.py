"""Design-space exploration of the PIM plane size (Sec. III-B, Fig. 6).

Sweeps ``n_row x n_col x n_stack``, evaluating latency (Eq. 3/5), energy
(Eq. 6) and cell density (Eq. 4), then selects the densest configuration
meeting the ~2 us PIM-latency target.  Reproduces the paper's choice of
Size A = 256 x 2048 x 128.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch.core.pim import density as densmod
from repro_torch.core.pim import energy as emod
from repro_torch.core.pim import latency as lmod
from repro_torch.core.pim import params as P
from repro_torch.core.pim.params import PlaneConfig

# Fig. 6 sweep baseline: remaining two parameters fixed at N_col=1K, N_stack=128
# (and N_row=256 when N_row is not the swept parameter).
_BASE = dict(n_row=256, n_col=1024, n_stack=128)
ROW_SWEEP = (64, 128, 256, 512, 1024, 2048, 4096)
COL_SWEEP = (256, 512, 1024, 2048, 4096, 8192, 16384)
STACK_SWEEP = (16, 32, 64, 96, 128)
# [9], [10]: contemporary devices are 64-128 WL layers; string current and
# staircase etch limit the stack count in the simulated technology.
MAX_STACK = 128


@dataclasses.dataclass(frozen=True)
class DsePoint:
    cfg: PlaneConfig
    t_pim_s: float
    t_read_s: float
    energy_j: float
    density_gb_mm2: float

    def as_row(self) -> dict:
        return {
            "n_row": self.cfg.n_row,
            "n_col": self.cfg.n_col,
            "n_stack": self.cfg.n_stack,
            "t_pim_us": self.t_pim_s * 1e6,
            "t_read_us": self.t_read_s * 1e6,
            "energy_nj": self.energy_j * 1e9,
            "density_gb_mm2": self.density_gb_mm2,
        }


def evaluate(cfg: PlaneConfig) -> DsePoint:
    return DsePoint(
        cfg=cfg,
        t_pim_s=lmod.t_pim(cfg),
        t_read_s=lmod.t_read(cfg),
        energy_j=emod.per_op(cfg).total,
        density_gb_mm2=densmod.cell_density_gb_per_mm2(cfg),
    )


def sweep_fig6(dim: str) -> list[DsePoint]:
    """One Fig. 6 panel: vary ``dim`` with the other two fixed at the baseline."""
    sweeps = {"n_row": ROW_SWEEP, "n_col": COL_SWEEP, "n_stack": STACK_SWEEP}
    out = []
    for v in sweeps[dim]:
        kw = dict(_BASE)
        kw[dim] = v
        out.append(evaluate(PlaneConfig(**kw)))
    return out


def grid(rows: Sequence[int] = ROW_SWEEP, cols: Sequence[int] = COL_SWEEP,
         stacks: Sequence[int] = STACK_SWEEP) -> Iterable[PlaneConfig]:
    for r in rows:
        for c in cols:
            for s in stacks:
                yield PlaneConfig(n_row=r, n_col=c, n_stack=s)


def select_plane(t_pim_cap: float = P.T_PIM_TARGET,
                 max_stack: int = MAX_STACK) -> DsePoint:
    """Max cell density s.t. T_PIM <= cap.

    Density is independent of ``n_row`` (Eq. 4: W ~ n_row), so among
    equal-density candidates we prefer the largest per-plane capacity
    (fewest planes per GiB => least H-tree/command overhead), which is the
    role ``n_row`` plays in Table I (4 BLS x 64 blocks = 256).
    """
    best: DsePoint | None = None
    for cfg in grid():
        if cfg.n_stack > max_stack or cfg.n_row < P.U_ROWS:
            continue
        pt = evaluate(cfg)
        if pt.t_pim_s > t_pim_cap:
            continue
        if best is None:
            best = pt
            continue
        key = (round(pt.density_gb_mm2, 4), cfg.capacity_bits)
        best_key = (round(best.density_gb_mm2, 4), best.cfg.capacity_bits)
        if key > best_key:
            best = pt
    assert best is not None
    return best
