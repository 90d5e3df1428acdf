"""Parasitic R/C extraction for a 3D NAND plane (inputs to Eq. (5)/(6)).

Every quantity scales with the plane configuration exactly as described in
Sec. III-B of the paper:

  * BL runs in the y direction across ``n_row`` strings  -> R_BL, C_BL ~ n_row
  * BLS runs in the x direction across ``n_col`` strings -> R_BLS, C_BLS ~ n_col
  * WL plate spans the cell region                       -> C_cell ~ n_col
  * staircase contacts                                   -> C_stair ~ n_stack
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.pim import params as P
from repro_torch.core.pim.params import PlaneConfig


@dataclasses.dataclass(frozen=True)
class PlaneRC:
    r_bl: float        # full bitline resistance [Ohm]
    c_bl: float        # full bitline wire capacitance [F]
    r_bls: float       # full BLS line resistance [Ohm]
    c_bls: float       # full BLS line capacitance [F]
    c_cell: float      # WL plate capacitance over the cell region [F]
    c_stair: float     # staircase contact capacitance [F]
    c_string_total: float  # total string loading on one BL (n_row strings) [F]
    c_string_per: float    # per-string drain load (Eq. 6a's C_string) [F]
    c_precharge_gates: float  # total precharge-transistor gate cap (n_col * C_INV) [F]


def extract(cfg: PlaneConfig) -> PlaneRC:
    return PlaneRC(
        r_bl=P.R_BL_PER_ROW * cfg.n_row,
        c_bl=P.C_BL_PER_ROW * cfg.n_row,
        r_bls=P.R_BLS_PER_COL * cfg.n_col,
        c_bls=P.C_BLS_PER_COL * cfg.n_col,
        c_cell=P.C_CELL_PER_COL * cfg.n_col,
        c_stair=P.C_STAIR_PER_STACK * cfg.n_stack,
        c_string_total=P.C_STRING_PER_ROW * cfg.n_row,
        c_string_per=P.C_STRING_PER_ROW,
        c_precharge_gates=P.C_INV * cfg.n_col,
    )
