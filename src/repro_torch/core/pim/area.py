"""Area model (Sec. V-C, Table II).

Peri-under-array (PUA): all PIM peripheral circuits sit *under* the memory
array, so they are free as long as their summed area stays below the plane
footprint.  Component areas are calibrated to Table II at Size A
(256 x 2048 x 128) and scale with the structures they serve:

  * HV-peri (WL decoder + pumps)            ~ n_row   (one driver per BLS/block row)
  * LV-peri (BLS dec, precharge, mux, ADC,
    page buffer, shift-adder)               ~ n_col   (per-bitline circuits)
  * RPU + H-tree wiring                     fixed per plane (synthesised @7nm)
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.pim.params import PlaneConfig, SIZE_A, PLANES_PER_DIE

# Table II calibration points (per plane, Size A, 7nm).
_HV_PERI_SIZE_A_MM2 = 0.004210      # 21.62 % of plane
_LV_PERI_SIZE_A_MM2 = 0.004510      # 23.16 % of plane
_RPU_HTREE_MM2 = 0.000077           # 0.39 % of plane (fixed)

# BGA316 package budget (Sec. V-C).
_BGA_W_MM, _BGA_H_MM = 14.0, 18.0
_DIES_PER_PACKAGE = 32
_DIES_PER_STACK = 4
_STACK_EXPOSURE = 2.38              # 4 dies @60 % overlap expose ~2.38 die footprints
_OCCUPANCY = (0.30, 0.40)           # dies occupy 30-40 % of the package


@dataclasses.dataclass(frozen=True)
class AreaBreakdown:
    plane_mm2: float
    hv_peri_mm2: float
    lv_peri_mm2: float
    rpu_htree_mm2: float

    @property
    def peri_total_mm2(self) -> float:
        return self.hv_peri_mm2 + self.lv_peri_mm2 + self.rpu_htree_mm2

    @property
    def fits_under_array(self) -> bool:
        """All peripherals must fit under the plane (PUA)."""
        return self.peri_total_mm2 <= self.plane_mm2

    def ratio(self, component_mm2: float) -> float:
        return component_mm2 / self.plane_mm2


def plane_area(cfg: PlaneConfig) -> AreaBreakdown:
    return AreaBreakdown(
        plane_mm2=cfg.area_mm2,
        hv_peri_mm2=_HV_PERI_SIZE_A_MM2 * cfg.n_row / SIZE_A.n_row,
        lv_peri_mm2=_LV_PERI_SIZE_A_MM2 * cfg.n_col / SIZE_A.n_col,
        rpu_htree_mm2=_RPU_HTREE_MM2,
    )


def die_area_mm2(cfg: PlaneConfig, planes_per_die: int = PLANES_PER_DIE) -> float:
    """Total array area of one die (planes only; peri is underneath)."""
    return cfg.area_mm2 * planes_per_die


def die_budget_mm2() -> tuple[float, float]:
    """Per-die area budget from the BGA316 packaging argument (Sec. V-C)."""
    pkg = _BGA_W_MM * _BGA_H_MM
    lo = pkg * _OCCUPANCY[0] * _STACK_EXPOSURE / _DIES_PER_PACKAGE
    hi = pkg * _OCCUPANCY[1] * _STACK_EXPOSURE / _DIES_PER_PACKAGE
    return lo, hi


def fits_budget(cfg: PlaneConfig, planes_per_die: int = PLANES_PER_DIE) -> bool:
    lo, _ = die_budget_mm2()
    return die_area_mm2(cfg, planes_per_die) <= lo
