"""Cell-density model, Eq. (4):  D = (Ncol*Nstack*Bcell)/(Lcell+Lstair) * Nrow/W."""
from __future__ import annotations

from repro_torch.core.pim import params as P
from repro_torch.core.pim.params import PlaneConfig


def cell_density_gb_per_mm2(cfg: PlaneConfig) -> float:
    """Gb/mm^2.  Note D is independent of n_row since W ~ n_row (Sec. III-B)."""
    bits = cfg.capacity_bits * P.ARRAY_EFFICIENCY
    return bits / cfg.area_mm2 / 1e9


def plane_capacity_gib(cfg: PlaneConfig) -> float:
    return cfg.capacity_bits / 8 / 2**30
