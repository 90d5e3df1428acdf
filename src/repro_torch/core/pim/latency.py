"""Latency models: Eq. (1) page read, Eq. (3) PIM op, Eq. (5) components."""
from __future__ import annotations

import dataclasses

from repro_torch.core.pim import params as P
from repro_torch.core.pim import rc as rcmod
from repro_torch.core.pim.params import PlaneConfig, horowitz


@dataclasses.dataclass(frozen=True)
class LatencyBreakdown:
    t_dec_wl: float
    t_dec_bls: float
    t_pre: float
    t_sense: float
    t_accum: float
    t_dis: float

    @property
    def per_bit(self) -> float:
        """One input-bit pass: max(t_decBLS, t_pre) + sense + accum + dis."""
        return max(self.t_dec_bls, self.t_pre) + self.t_sense + self.t_accum + self.t_dis


def components(cfg: PlaneConfig) -> LatencyBreakdown:
    """Eq. (5a-c) with the Horowitz delay h(tau) ~ tau^1.5."""
    rc = rcmod.extract(cfg)
    # Eq. (5a): switch driving n_col precharge gates + BL RC precharge.
    t_pre = horowitz(P.R_SWITCH * rc.c_precharge_gates) + horowitz(
        rc.r_bl * (rc.c_bl / 2.0 + rc.c_string_total)
    )
    # Eq. (5b): distributed BLS line.
    t_dec_bls = horowitz(rc.r_bls * rc.c_bls / 2.0)
    # Eq. (5c): pass transistor driving the WL plate + staircase.
    t_dec_wl = horowitz(P.R_SWITCH * (rc.c_cell + rc.c_stair))
    return LatencyBreakdown(
        t_dec_wl=t_dec_wl,
        t_dec_bls=t_dec_bls,
        t_pre=t_pre,
        t_sense=P.T_SENSE_PIM,
        t_accum=P.T_ACCUM,
        t_dis=P.T_DIS,
    )


def t_pim(cfg: PlaneConfig, b_input: int = P.A_BITS) -> float:
    """Eq. (3): T_PIM = t_decWL + (max(t_decBLS, t_pre)+sense+accum+dis) * B_input."""
    lb = components(cfg)
    return lb.t_dec_wl + lb.per_bit * b_input


def t_read(cfg: PlaneConfig) -> float:
    """Eq. (1): regular page read.

    A cell storing ``b_cell`` bits needs ``(2**b_cell - 1) / b_cell``
    reference-level sense passes per logical page on average (QLC: 3.75,
    SLC: 1), which is what separates Z-NAND-class SLC reads from 20-50 us
    conventional QLC reads.
    """
    lb = components(cfg)
    n_pass = ((1 << cfg.b_cell) - 1) / cfg.b_cell
    per_pass = max(lb.t_dec_bls, lb.t_pre) + P.T_SENSE_READ
    return lb.t_dec_wl + per_pass * n_pass + lb.t_dis


# ----------------------------------------------------------------------------
# KV tier transfers (hot slot pool <-> cold SLC-resident tier)
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TierTransfer:
    """Modeled cost of moving ``n_bytes`` of quantized KV rows between the
    hot slot pool and the cold SLC tier.

    ``t_out`` (hot -> cold) is bounded by the device-level sequential SLC
    program bandwidth ([19], multi-plane program overlap already folded into
    ``SLC_WRITE_BPS``); ``t_in`` (cold -> hot) pays one Eq. (1) SLC page read
    per page (spread over ``planes`` planes read in parallel) plus the flash
    bus, each side plus one command round.
    """

    n_bytes: int
    pages: int
    t_out: float
    t_in: float

    @property
    def cycles_out(self) -> int:
        """``t_out`` at the RPU clock (Table I)."""
        return int(round(self.t_out * P.RPU_CLOCK_HZ))

    @property
    def cycles_in(self) -> int:
        return int(round(self.t_in * P.RPU_CLOCK_HZ))


def slc_variant(cfg: PlaneConfig) -> PlaneConfig:
    """The same plane geometry programmed SLC (1 bit/cell)."""
    return dataclasses.replace(cfg, b_cell=P.SLC_BITS)


def tier_transfer(n_bytes: int, cfg: PlaneConfig | None = None,
                  planes: int = 1) -> TierTransfer:
    """Cost entry point for one hot<->cold KV tier move of ``n_bytes``."""
    if cfg is None:
        cfg = P.SIZE_A
    if n_bytes <= 0:
        return TierTransfer(n_bytes=0, pages=0, t_out=0.0, t_in=0.0)
    pages = -(-n_bytes // P.PAGE_BYTES)
    t_out = P.CMD_OVERHEAD_S + n_bytes / P.SLC_WRITE_BPS
    rounds = -(-pages // max(1, planes))
    t_in = (P.CMD_OVERHEAD_S + rounds * t_read(slc_variant(cfg))
            + n_bytes / P.FLASH_BUS_BPS)
    return TierTransfer(n_bytes=int(n_bytes), pages=pages, t_out=t_out, t_in=t_in)


# ----------------------------------------------------------------------------
# on-die ECC decode (SLC-resident KV / weight reads)
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EccCost:
    """Modeled cost of one on-die BCH decode pass over ``n_bytes`` read
    from the SLC tier.

    Every 256 B page pays a syndrome computation
    (``ECC_SYNDROME_CYCLES_PER_PAGE`` at the RPU clock, pipelined behind
    the Eq. (1) page read); each corrected bit additionally pays the
    error-locator/Chien-search term ``ECC_CYCLES_PER_CORRECTED_BIT``.
    Pages with more than ``ECC_T_PER_PAGE`` raw flips are uncorrectable
    — no cost model applies; the read surfaces an integrity fault to the
    serving stack instead (serve/faults.py).
    """

    n_bytes: int
    pages: int
    corrected_bits: int
    t_decode: float

    @property
    def cycles(self) -> int:
        """``t_decode`` at the RPU clock (Table I)."""
        return int(round(self.t_decode * P.RPU_CLOCK_HZ))


def ecc_decode(n_bytes: int, corrected_bits: int = 0) -> EccCost:
    """Cost entry point for one ECC decode of ``n_bytes`` of SLC data."""
    if n_bytes <= 0:
        return EccCost(n_bytes=0, pages=0, corrected_bits=0, t_decode=0.0)
    pages = -(-n_bytes // P.PAGE_BYTES)
    cycles = (pages * P.ECC_SYNDROME_CYCLES_PER_PAGE
              + int(corrected_bits) * P.ECC_CYCLES_PER_CORRECTED_BIT)
    return EccCost(n_bytes=int(n_bytes), pages=pages,
                   corrected_bits=int(corrected_bits),
                   t_decode=cycles / P.RPU_CLOCK_HZ)
