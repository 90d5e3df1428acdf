"""Energy models: Eq. (6a-c) + sensing/accumulation energies (Fig. 6b)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.pim import params as P
from repro_torch.core.pim import rc as rcmod
from repro_torch.core.pim.params import PlaneConfig


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    e_pre: float       # Eq. (6a) BL precharge [J]
    e_dec_bls: float   # Eq. (6b) BLS decode [J]
    e_dec_wl: float    # Eq. (6c) WL decode [J]
    e_sense: float     # ADC conversions [J]
    e_accum: float     # shift-adder accumulation [J]

    @property
    def total(self) -> float:
        return self.e_pre + self.e_dec_bls + self.e_dec_wl + self.e_sense + self.e_accum


def per_op(cfg: PlaneConfig, b_input: int = P.A_BITS,
           input_sparsity: float = 0.5) -> EnergyBreakdown:
    """Energy of one PIM dot-product op (all ``b_input`` bit passes).

    ``input_sparsity`` is the fraction of zero input bits (alpha_i in Eq. 6a);
    the paper reports ~0.5 for its LLM benchmarks.
    """
    rc = rcmod.extract(cfg)
    n_row_active = cfg.tile_rows                       # N_row* = 128
    n_blocks_active = max(1, n_row_active // 4)        # 4 BLS per block

    # Eq. (6a): every BL precharged; strings of activated (non-zero-input) rows load it.
    e_pre_bit = cfg.n_col * P.V_PRE ** 2 * (
        rc.c_bl + rc.c_string_per * n_row_active * (1.0 - input_sparsity)
    )
    # Eq. (6b): activated BLS lines driven to V_pass; independent of n_row.
    e_bls_bit = n_row_active * P.V_PASS ** 2 * rc.c_bls
    # Eq. (6c): read-voltage WL in activated blocks + pass-voltage elsewhere.
    e_wl = n_blocks_active * (
        P.V_READ ** 2 * (rc.c_cell + rc.c_stair) + P.V_PASS ** 2 * (rc.c_cell + rc.c_stair)
    )
    # ADC: one conversion per (active output column, input bit).
    e_sense_bit = cfg.tile_cols * P.E_ADC_CONV
    # shift-adder: drives higher mux loads as n_col grows (Sec. III-B).
    e_accum_bit = cfg.tile_cols * P.E_ACCUM_PER_COL * (cfg.n_col / 2048.0)

    return EnergyBreakdown(
        e_pre=e_pre_bit * b_input,
        e_dec_bls=e_bls_bit * b_input,
        e_dec_wl=e_wl,
        e_sense=e_sense_bit * b_input,
        e_accum=e_accum_bit * b_input,
    )
