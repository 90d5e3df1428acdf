"""The port's copy of the paper's analytical PIM model (``repro_torch.core``:
``pim/*``, ``htree``, ``tiling``, ``pimsim``, ``mapping``) against the
reference's modules.

Both run the same Python float arithmetic, so every result must be equal
(``==``, no tolerance): each dataclass field and property, each number.  The
cases are those of ``tests/test_pim_model.py`` and
``tests/test_tiling_pimsim.py``, plus the tier-transfer and ECC entry points
the serve path prices with, and ``build_plan`` / ``flash_tpot_for`` for
every configuration the port serves.
"""
import dataclasses
import itertools

import pytest

from repro.configs import registry as JR
from repro.core import htree as J_htree
from repro.core import mapping as J_mapping
from repro.core import pimsim as J_pimsim
from repro.core import tiling as J_tiling
from repro.core import pim as J_pim
from repro.core.pim import area as J_area
from repro.core.pim import density as J_density
from repro.core.pim import dse as J_dse
from repro.core.pim import energy as J_energy
from repro.core.pim import latency as J_latency
from repro.core.pim import params as J_params
from repro.core.pim import rc as J_rc
from repro_torch.configs import registry as TR
from repro_torch.core import htree as T_htree
from repro_torch.core import mapping as T_mapping
from repro_torch.core import pimsim as T_pimsim
from repro_torch.core import tiling as T_tiling
from repro_torch.core import pim as T_pim
from repro_torch.core.pim import area as T_area
from repro_torch.core.pim import density as T_density
from repro_torch.core.pim import dse as T_dse
from repro_torch.core.pim import energy as T_energy
from repro_torch.core.pim import latency as T_latency
from repro_torch.core.pim import params as T_params
from repro_torch.core.pim import rc as T_rc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MOD = {"params": (J_params, T_params), "rc": (J_rc, T_rc),
       "latency": (J_latency, T_latency), "energy": (J_energy, T_energy),
       "density": (J_density, T_density), "area": (J_area, T_area),
       "dse": (J_dse, T_dse), "htree": (J_htree, T_htree),
       "tiling": (J_tiling, T_tiling), "pimsim": (J_pimsim, T_pimsim),
       "mapping": (J_mapping, T_mapping), "pim": (J_pim, T_pim)}


def _plain(x):
    """A comparable form of a model result: dataclasses become (class name,
    fields and properties), containers recurse, numbers stay as they are."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        d = {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
        for name in dir(type(x)):
            if isinstance(getattr(type(x), name, None), property):
                d[name] = _plain(getattr(x, name))
        return type(x).__name__, d
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _port_arg(x):
    """The port's copy of a reference argument (a plane geometry, a tiling
    hierarchy or config, an OPT model: the same fields, the port's class)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        for mod in (T_params, T_tiling, T_pimsim):
            cls = getattr(mod, type(x).__name__, None)
            if cls is not None:
                return cls(**{f.name: _port_arg(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_port_arg(v) for v in x)
    return x


def _same(module: str, fn: str, *args, **kwargs):
    """Call ``fn`` of both copies of ``module`` on the same arguments and hold
    the results equal."""
    j, t = MOD[module]
    want = getattr(j, fn)(*args, **kwargs)
    got = getattr(t, fn)(*(_port_arg(a) for a in args),
                         **{k: _port_arg(v) for k, v in kwargs.items()})
    if hasattr(want, "__next__"):
        want, got = list(want), list(got)
    assert _plain(got) == _plain(want), (module, fn, args, kwargs)
    return want


PLANES = [J_params.SIZE_A, J_params.SIZE_B, J_params.CONVENTIONAL,
          J_params.PlaneConfig(256, 4096, 128), J_params.PlaneConfig(1024, 1024, 128),
          J_params.PlaneConfig(4096, 1024, 128), J_params.PlaneConfig(128, 2048, 128)]
# test_latency_monotone_in_each_dim's sweep
PLANES += [J_params.PlaneConfig(**{**dict(n_row=256, n_col=1024, n_stack=128), dim: v})
           for dim, vals in [("n_row", (256, 1024, 4096)),
                             ("n_col", (1024, 4096, 16384)),
                             ("n_stack", (32, 64, 128))] for v in vals]


def test_params_constants_equal():
    """Every module-level constant of ``params`` (the paper's Table I and
    device constants) and ``horowitz`` agree."""
    names = [n for n in dir(J_params) if n.isupper()]
    assert names and names == [n for n in dir(T_params) if n.isupper()]
    for n in names:
        assert _plain(getattr(T_params, n)) == _plain(getattr(J_params, n)), n
    for tau in (0.0, 1e-12, 3.7e-10, 2e-9, 1e-6):
        _same("params", "horowitz", tau)


@pytest.mark.parametrize("plane", PLANES, ids=str)
def test_plane_models_equal(plane):
    """Latency (``components``, ``t_pim``, ``t_read``), RC extraction,
    energy, density, area and the DSE point of one plane geometry."""
    _same("latency", "components", plane)
    _same("latency", "t_pim", plane)
    _same("latency", "t_pim", plane, b_input=4)
    _same("latency", "t_read", plane)
    _same("latency", "slc_variant", plane)
    _same("rc", "extract", plane)
    _same("energy", "per_op", plane)
    _same("density", "cell_density_gb_per_mm2", plane)
    _same("density", "plane_capacity_gib", plane)
    _same("area", "plane_area", plane)
    _same("area", "die_area_mm2", plane)
    _same("area", "fits_budget", plane)
    _same("dse", "evaluate", plane)


def test_package_reexports_equal():
    """``core/pim/__init__.py``'s re-exports: the same names, bound to the
    port's functions, with the same results."""
    names = [n for n in dir(J_pim) if not n.startswith("_")
             and n not in ("params", "latency", "energy", "density", "area",
                           "dse", "rc")]
    assert set(names) <= set(dir(T_pim))
    for n in ("t_pim", "t_read", "energy_per_op", "cell_density_gb_per_mm2",
              "plane_area", "die_area_mm2"):
        _same("pim", n, J_params.SIZE_A)
    _same("pim", "die_budget_mm2")
    _same("pim", "select_plane")


@pytest.mark.parametrize("dim", ["n_row", "n_col", "n_stack"])
def test_dse_sweeps_equal(dim):
    """Fig. 6's panels, the grid and the selected plane (Sec. III-B)."""
    _same("dse", "sweep_fig6", dim)
    _same("dse", "grid")
    _same("dse", "select_plane")
    _same("dse", "select_plane", t_pim_cap=3e-6, max_stack=96)


@pytest.mark.parametrize("n_bytes", [0, 1, 255, 256, 257, 4096, 65_536, 1_048_577])
def test_tier_transfer_and_ecc_equal(n_bytes):
    """The serve path's pricing: ``tier_transfer`` (with its RPU-clock
    cycles) on the default, SIZE_B and SLC planes with 1 and 8 planes, and
    ``ecc_decode`` with and without corrected bits."""
    for plane in (None, J_params.SIZE_B, J_latency.slc_variant(J_params.SIZE_A)):
        for planes in (1, 8):
            _same("latency", "tier_transfer", n_bytes, plane, planes=planes)
    for bits in (0, 1, 7, 40):
        _same("latency", "ecc_decode", n_bytes, corrected_bits=bits)


def test_htree_cases_equal():
    """Fig. 9a / 9b and ``tree_depth``."""
    _same("htree", "fig9a_cases")
    _same("htree", "fig9b_cases")
    for leaves in (1, 2, 3, 4, 16, 63, 64, 256, 1000):
        _same("htree", "tree_depth", leaves)


@pytest.mark.parametrize("m", [512, 1024, 2048, 4096, 7168])
def test_htree_grid_equal(m):
    """``shared_bus_time`` and ``htree_time`` over the property test's whole
    grid (``test_htree_regimes``) and ``test_more_planes_never_slower``'s."""
    for n, planes in itertools.product([512, 1024, 4096, 8192], [16, 64, 256]):
        _same("htree", "shared_bus_time", m, n, planes, J_params.SIZE_A)
        _same("htree", "htree_time", m, n, planes, J_params.SIZE_A)


def test_tiling_equal():
    """Fig. 12's three cases and the searches ``tests/test_tiling_pimsim.py``
    runs."""
    _same("tiling", "fig12_cases")
    _same("tiling", "search", 7168, 7168, top_k=3)
    _same("tiling", "search", 7168, 7168, htree=False, top_k=1)
    _same("tiling", "search", 4096, 4096, top_k=1)
    _same("tiling", "search", 7168, 28672, top_k=5)
    hier = J_tiling.Hierarchy(die=8)
    _same("tiling", "enumerate_configs", 7168, 7168, hier)


@pytest.mark.parametrize("name", sorted(J_pimsim.OPT_MODELS))
def test_pimsim_equal(name):
    """The system TPOT model (Fig. 5 / 14) and Sec. IV-B's numbers for each
    OPT model."""
    assert _plain(T_pimsim.OPT_MODELS[name]) == _plain(J_pimsim.OPT_MODELS[name])
    m = J_pimsim.OPT_MODELS[name]
    for ctx in (1024, 4096):
        _same("pimsim", "flash_tpot", m, ctx)
        _same("pimsim", "dmvm_time", m, ctx)
        _same("pimsim", "controller_times", m, ctx)
    _same("pimsim", "smvm_time", m)
    _same("pimsim", "naive_tpot", m)
    for gpu in sorted(J_pimsim.GPU_SPECS):
        _same("pimsim", "gpu_fits", m, gpu)
        _same("pimsim", "gpu_tpot", m, gpu)
        _same("pimsim", "gpu_prefill", m, gpu, 1024)
    _same("pimsim", "initial_kv_write_s", m)
    _same("pimsim", "offload_breakeven_tokens", m)
    _same("pimsim", "slc_lifetime_years", m)
    _same("pimsim", "kv_write_excess", m, 1e-3)


@pytest.mark.parametrize("arch", sorted(TR.ARCHS))
def test_mapping_equal_for_served_configs(arch):
    """``build_plan`` and ``flash_tpot_for`` over the port's own
    ``configs/base.py``, at full size and ``.reduced()``, for every
    configuration the port serves (the engine's swap-vs-recompute
    crossover prices a replayed token with ``flash_tpot_for``)."""
    for jcfg, tcfg in ((JR.get(arch), TR.get(arch)),
                       (JR.get(arch).reduced(), TR.get(arch).reduced())):
        assert _plain(tcfg) == _plain(jcfg)
        for ctx in (256, 1024, 8192):
            want = J_mapping.build_plan(jcfg, context_len=ctx)
            assert _plain(T_mapping.build_plan(tcfg, context_len=ctx)) == _plain(want)
            want = J_mapping.flash_tpot_for(jcfg, context_len=ctx)
            assert T_mapping.flash_tpot_for(tcfg, context_len=ctx) == want


def test_port_imports_nothing_of_the_reference():
    """The copies import neither JAX nor the reference package."""
    import ast
    from pathlib import Path
    root = Path(T_params.__file__).resolve().parents[1]
    files = sorted((root / "pim").glob("*.py")) + [
        root / f for f in ("htree.py", "tiling.py", "pimsim.py", "mapping.py")]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                for m in mods:
                    assert m.split(".")[0] not in ("jax", "repro"), (f, m)
