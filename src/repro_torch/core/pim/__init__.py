"""Analytical models of the 3D NAND flash PIM device (the paper's Secs. II-III, V)."""
from repro_torch.core.pim.params import (  # noqa: F401
    PlaneConfig,
    SIZE_A,
    SIZE_B,
    CONVENTIONAL,
    horowitz,
)
from repro_torch.core.pim.latency import t_pim, t_read, components  # noqa: F401
from repro_torch.core.pim.energy import per_op as energy_per_op  # noqa: F401
from repro_torch.core.pim.density import cell_density_gb_per_mm2  # noqa: F401
from repro_torch.core.pim.area import plane_area, die_area_mm2, die_budget_mm2  # noqa: F401
from repro_torch.core.pim.dse import select_plane, sweep_fig6, evaluate  # noqa: F401
