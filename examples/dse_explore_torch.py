"""Reproduce the paper's design-space exploration interactively (Fig. 6)
with the PyTorch port's copy of the analytical model: sweep the plane
geometry, print the latency/energy/density frontier, and confirm the Size-A
choice; then show the H-tree's effect (Fig. 9) and the best tiling for a
model of your choice (Fig. 11-12).  Prints what ``examples/dse_explore.py``
prints, line for line.

Run:  PYTHONPATH=src python examples/dse_explore_torch.py [--d-model 7168]
(the model is arithmetic on the host: no device is used).
"""
import argparse

from repro_torch.core import htree, tiling
from repro_torch.core.pim import dse

ap = argparse.ArgumentParser()
ap.add_argument("--d-model", type=int, default=7168)
args = ap.parse_args()

print("== Fig. 6: plane-size sweeps (latency us | energy nJ | Gb/mm^2) ==")
for dim in ("n_row", "n_col", "n_stack"):
    print(f"-- sweep {dim} --")
    for pt in dse.sweep_fig6(dim):
        r = pt.as_row()
        print(f"  {r['n_row']:5d} x {r['n_col']:5d} x {r['n_stack']:3d}: "
              f"{r['t_pim_us']:8.2f} | {r['energy_nj']:7.2f} | "
              f"{r['density_gb_mm2']:6.2f}")

sel = dse.select_plane()
print(f"\nselected plane: {sel.cfg}  (paper: 256x2048x128) "
      f"t_pim={sel.t_pim_s*1e6:.2f}us density={sel.density_gb_mm2:.2f}Gb/mm^2")

print("\n== Fig. 9a: shared bus vs H-tree (64 Size-A planes) ==")
for name, sh, ht in htree.fig9a_cases():
    print(f"  {name}: shared {sh.total*1e6:7.2f}us -> htree {ht.total*1e6:6.2f}us "
          f"(-{(1-ht.total/sh.total)*100:.0f}%)")

print(f"\n== Fig. 12: best tilings for a ({args.d_model} x {args.d_model}) sMVM ==")
for c in tiling.search(args.d_model, args.d_model, top_k=5):
    print(f"  {c.config.label:10s} counts={c.config.counts}  "
          f"total={c.total*1e6:7.2f}us (in={c.t_in*1e6:.2f} pim={c.t_pim*1e6:.2f} "
          f"out={c.t_out*1e6:.2f})")
