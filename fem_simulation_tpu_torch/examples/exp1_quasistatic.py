"""exp1 quasi-static: Newton-Multigrid / FAS on a hex mesh, with plots.

Port of `examples/exp1_quasistatic.py` (the reference's
exp1/quasi_simulation/main.py): build the scene, run a solver, plot the
convergence and the levels.

    python -m fem_simulation_tpu_torch.examples.exp1_quasistatic [--solver fas3]

--mesh voxelizes an OBJ; the default is the procedural beam (--beam, added
here with --device).
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import mesh as meshlib
from ..config import SolverConfig
from ..ops import stencil
from ..sim import QuasiStaticSim, Scene
from ..utils import viz
from ._common import beam_shape, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dx", type=float, default=0.05)
    ap.add_argument("--beam", default="8,8,24")
    ap.add_argument("--solver", default="newton_mg",
                    choices=["newton", "newton_mg", "fas0", "fas1", "fas2",
                             "fas3", "adam", "gd", "lattice"])
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=None,
                    help="output prefix (default: results/exp1_torch)")
    args = ap.parse_args(argv)
    out = out_path(args.out, "exp1_torch")

    m = meshlib.load_hex_mesh(args.mesh, args.dx,
                              beam_shape=beam_shape(args.beam))
    print(f"{m.n_verts} verts, {m.n_hexes} hexes")
    scene = Scene(m, solver=SolverConfig(), device=args.device)
    sim = QuasiStaticSim(scene)

    if args.solver == "lattice":
        from ..sim.lattice import LatticeScene, quasistatic_to_tol
        ls = LatticeScene(m, device=args.device)
        x, k, f = quasistatic_to_tol(ls, ls.x0, tol=1e-4,
                                     max_newton=args.iterations)
        print(f"lattice Newton: {k} iterations, ||f||_inf = {f:.3e}")
        sim.x = scene.from_mesh_order(scene.to_mesh_order(
            stencil.field_from_lattice(x, ls.lat)))
        e = fn = np.asarray([f], np.float32)
    elif args.solver == "newton":
        e, fn = sim.newton(args.iterations)
    elif args.solver == "newton_mg":
        e, fn = sim.newton_multigrid(args.iterations)
    elif args.solver.startswith("fas"):
        e, fn = sim.fas(args.iterations, variant=int(args.solver[3]))
    elif args.solver == "adam":
        fn = sim.adam(args.iterations)
        e = fn
    else:
        fn = sim.gradient_descent(args.iterations)
        e = fn

    fn = np.asarray(fn)
    print(f"||f||_inf: {fn[0]:.4e} -> {fn[-1]:.4e}")
    viz.show(scene, sim, np.asarray(e), fn, out)
    for li in range(scene.n_levels):
        viz.render_level(scene, li, f"{out}_level{li}.png")
    print(f"wrote {out}_*.png")
    return fn


if __name__ == "__main__":
    main()
