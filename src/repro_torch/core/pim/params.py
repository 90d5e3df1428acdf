"""Physical / architectural parameters of the 3D NAND flash PIM device.

All constants are calibrated so that the analytical models in this package
reproduce the paper's reported numbers:

  * Size A plane (256 x 2048 x 128) PIM latency  ~= 2 us      (Sec. III-B)
  * Size A cell density                          = 12.84 Gb/mm^2 (Fig. 6c)
  * Size B density exactly half of Size A        (Fig. 9b: "2x higher")
  * 256 planes of Size A                         ~= 4.98 mm^2 (Sec. V-C)
  * conventional-plane read latency              ~= 20-50 us  (Sec. III-A)

Geometry is solved in closed form (see DESIGN.md Sec. 1): with a 150 nm
string pitch, a 1.5578 um-per-layer staircase step and a 93.04 % array
efficiency, both the density and the die-area targets hold simultaneously.
"""
from __future__ import annotations

import dataclasses
import math

# ----------------------------------------------------------------------------
# geometry
# ----------------------------------------------------------------------------
STRING_PITCH_UM: float = 0.15          # x/y string pitch [um]
STAIR_STEP_UM: float = 1.5578          # staircase length per stack layer [um]
ARRAY_EFFICIENCY: float = 0.9304       # dummy WLs / edge loss factor

# ----------------------------------------------------------------------------
# electrical (per-unit R/C; "per row/col" means per string pitch)
# ----------------------------------------------------------------------------
R_SWITCH: float = 20e3                 # WL/precharge driver switch resistance [Ohm]
C_INV: float = 0.4e-15                 # per-column precharge gate cap [F]
R_BL_PER_ROW: float = 200.0            # copper bitline resistance per row [Ohm]
C_BL_PER_ROW: float = 0.06e-15        # bitline wire cap per row [F]
C_STRING_PER_ROW: float = 0.15e-15    # per-string drain load on the BL [F]
R_BLS_PER_COL: float = 2.0             # tungsten BLS line resistance per col [Ohm]
C_BLS_PER_COL: float = 0.05e-15       # BLS cap per col [F]
C_CELL_PER_COL: float = 0.3e-15       # WL plate (cell region) cap per col [F]
C_STAIR_PER_STACK: float = 1.2e-15    # staircase cap per stack layer [F]
                                       # (C_stair == C_cell at N_col=512, N_stack=128,
                                       #  as stated in Sec. III-B)

# voltages
V_PRE: float = 1.0                     # BL precharge voltage [V]
V_PASS: float = 6.0                    # pass voltage [V]
V_READ: float = 2.0                    # read voltage [V]

# fixed-latency components (SAR ADC / shift-adder / discharge)
T_SENSE_PIM: float = 110e-9            # 9-bit SAR ADC conversion (PIM mode) [s]
T_SENSE_READ: float = 1e-6             # one reference-level sense pass, regular
                                       # page read (cell settling; SLC => Z-NAND-class)
T_ACCUM: float = 20e-9                 # shift-adder accumulation (pipelined) [s]
T_DIS: float = 40e-9                   # BL/BLS discharge [s]
E_ADC_CONV: float = 2e-12              # 9-bit SAR ADC energy per conversion [J]
E_ACCUM_PER_COL: float = 0.05e-12     # shift-adder energy per output col [J]

# DSE latency target (Sec. III-B: "~2us PIM latency")
T_PIM_TARGET: float = 1.9e-6

# Horowitz delay:  h(tau) = K_H * tau * sqrt(tau / TAU_REF)   (~ tau^1.5,
# as stated below Eq. (5); TAU_REF anchors the units)
K_HOROWITZ: float = 0.7
TAU_REF: float = 1e-9

# ----------------------------------------------------------------------------
# PIM-mode architectural constants (Sec. II-B / III-B)
# ----------------------------------------------------------------------------
U_ROWS: int = 128                      # simultaneously activated BLSs per dot product
                                       # (256 QLC cells on a BL / 2 cells per 8b weight)
COL_MUX: int = 4                       # 4:1 column multiplexer in front of the ADCs
ADC_BITS: int = 9                      # SAR ADC resolution
W_BITS: int = 8                        # weight bits (two QLC cells)
A_BITS: int = 8                        # activation bits (bit-serial input)
QLC_BITS: int = 4                      # bits per QLC cell
SLC_BITS: int = 1

# ----------------------------------------------------------------------------
# device hierarchy (Table I)
# ----------------------------------------------------------------------------
N_CHANNELS: int = 8
N_WAYS: int = 4                        # packages per channel
N_DIES: int = 8                        # dies per way  (2 SLC + 6 QLC)
N_SLC_DIES: int = 2
N_QLC_DIES: int = 6
PLANES_PER_DIE: int = 256
FLASH_BUS_BPS: float = 2e9             # per-channel flash bus [B/s] (1000MT/s x 8b)
HTREE_LINK_BPS: float = 4e9            # RPU-to-RPU H-tree link (64b @ 250 MHz x2)
RPU_CLOCK_HZ: float = 250e6
RPU_MACS_PER_CYCLE: int = 8            # INT16 multipliers per RPU (Table I)
SLC_WRITE_BPS: float = 5.4e9           # sequential SLC write bandwidth [B/s] ([19]: 4.8-6)
PCIE_BPS: float = 15.75e9              # PCIe 5.0 x4 [B/s]
ARM_CORES: int = 4
ARM_FLOPS: float = 4e9                 # FP16 FLOP/s per ARM Cortex-A9 core (NEON)
CMD_OVERHEAD_S: float = 1e-6           # flash command issue/sync overhead per round

# QLC/SLC program & endurance ([16], [17])
T_PROG_SLC: float = 100e-6             # SLC page program [s]
T_PROG_QLC: float = 1.9e-3             # QLC page program (19x slower, [16])
PE_CYCLES_SLC: float = 10e3            # nominal SLC P/E cycles
RETENTION_RELAX_FACTOR: float = 50.0   # 3-day retention endurance gain ([17])
PAGE_BYTES: int = 256                  # Table I: page size = 256 B

# SLC raw bit-error rates and on-die ECC ([17]-class SLC reliability data;
# Cambricon-LLM makes the same on-die error handling load-bearing for
# NAND-resident LLM state).  Retention errors accumulate while a cold
# block rests (the 3-day relaxed-retention operating point the
# RETENTION_RELAX_FACTOR endurance gain assumes); read disturb is the
# per-pass rate on hot SLC pages.  The ECC is a BCH-class code over each
# 256 B page: up to ECC_T_PER_PAGE flipped bits correct transparently
# (syndrome pass pipelined behind the Eq. (1) page read, plus an
# error-locator/Chien-search term per corrected bit at the RPU clock);
# a page beyond t is uncorrectable and surfaces to the serving stack.
RBER_SLC_RETENTION: float = 5e-7       # resting cold blocks [bit errors/bit]
RBER_SLC_READ_DISTURB: float = 1e-8    # per read pass on a hot SLC page
ECC_T_PER_PAGE: int = 8                # BCH correction capability t / 256 B page
ECC_SYNDROME_CYCLES_PER_PAGE: int = 64   # syndrome computation per page
ECC_CYCLES_PER_CORRECTED_BIT: int = 128  # error locator + Chien search per bit


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    """A 3D NAND plane: ``n_row x n_col x n_stack`` (Sec. III-B)."""

    n_row: int = 256                   # number of BLSs (4 BLS/block x 64 blocks)
    n_col: int = 2048                  # number of BLs (page size * 8 / B_cell carrier)
    n_stack: int = 128                 # stacked WL layers
    b_cell: int = QLC_BITS             # bits per cell (4 = QLC, 1 = SLC)

    # ---- derived geometry -------------------------------------------------
    @property
    def l_cell_um(self) -> float:
        return self.n_col * STRING_PITCH_UM

    @property
    def l_stair_um(self) -> float:
        return self.n_stack * STAIR_STEP_UM

    @property
    def width_um(self) -> float:
        return self.n_row * STRING_PITCH_UM

    @property
    def area_mm2(self) -> float:
        return self.width_um * (self.l_cell_um + self.l_stair_um) * 1e-6

    @property
    def capacity_bits(self) -> int:
        return self.n_row * self.n_col * self.n_stack * self.b_cell

    # ---- PIM tile shape ---------------------------------------------------
    @property
    def tile_rows(self) -> int:
        """Input rows consumed per PIM dot product (activated BLS limit)."""
        return min(U_ROWS, self.n_row)

    @property
    def tile_cols(self) -> int:
        """Output columns produced per PIM op (after the 4:1 mux and the
        2-cells-per-8b-weight pairing)."""
        return self.n_col // COL_MUX

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.n_row}x{self.n_col}x{self.n_stack}"


# The paper's chosen configurations.
SIZE_A = PlaneConfig(n_row=256, n_col=2048, n_stack=128)   # selected (Sec. III-B)
SIZE_B = PlaneConfig(n_row=256, n_col=1024, n_stack=64)    # smaller alternative
# A conventional plane: 4 BLS/block x 700 blocks, 4 KiB page, 128 stacks
# (Sec. III-A gives 700-2800 blocks and 20-50us reads).
CONVENTIONAL = PlaneConfig(n_row=2800, n_col=32768, n_stack=128)


def horowitz(tau: float) -> float:
    """Horowitz-style driver delay, ``h(tau) ~ tau^1.5`` (paper, below Eq. 5)."""
    return K_HOROWITZ * tau * math.sqrt(tau / TAU_REF)
