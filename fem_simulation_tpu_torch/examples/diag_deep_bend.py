"""Deep-bend cantilever diagnostics: the adaptive-continuation stage trace.

Port of `examples/diag_deep_bend.py`. The 37k-vertex cantilever (--beam
16,16,128, pinned at z min) is the repo's hardest quasi-static problem: the
StVK Hessian goes indefinite along the Newton path. One solve with
load_steps "auto" prints the per-stage (gravity_scale, newton_iters,
||f||_inf) trace, so the continuation's warm-start retries, halvings and
redoublings are visible.

    python -m fem_simulation_tpu_torch.examples.diag_deep_bend [--solver latmg]

The reference's JAX-only parts are dropped: its compile cache
(`enable_compile_cache`) and --no-pallas (every path here runs the CUDA
kernels on the GPU, their plain versions on the CPU). --device is added.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import mesh as meshlib
from ..sim.lattice import LatticeScene, quasistatic_to_tol
from ..sim.lattice_mg import LatticeMG, quasistatic_to_tol_mg
from ._common import beam_shape


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver", default="lattice",
                    choices=["lattice", "latmg"])
    ap.add_argument("--load-steps", default="auto",
                    type=lambda s: s if s == "auto" else int(s))
    ap.add_argument("--beam", default="16,16,128")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    m = meshlib.beam(*beam_shape(args.beam), dx=0.05)
    pins = np.nonzero(m.ijk[:, 2] == m.ijk[:, 2].min())[0]
    ls = LatticeScene(m, pins=pins, device=args.device)
    if args.solver == "latmg":
        mg = LatticeMG(ls, n_levels=2, dt=None, coarse_cg=8)

        def solve(xx, **kw):
            return quasistatic_to_tol_mg(ls, mg, xx, tol=1e-4,
                                         max_newton=100, **kw)
    else:
        def solve(xx, **kw):
            return quasistatic_to_tol(ls, xx, tol=1e-4, max_newton=100, **kw)
    print("verts", m.n_verts, "device", ls.device, flush=True)

    t0 = time.time()
    if args.load_steps == "auto":
        x, k, fn, tr = solve(ls.x0, load_steps="auto", return_trace=True)
        tr = np.asarray(tr)
    else:
        x, k, fn = solve(ls.x0, load_steps=args.load_steps)
        tr = None
    print("wall %.1fs  k %d  fn %g" % (time.time() - t0, k, fn), flush=True)
    if tr is not None:
        for row in tr[~np.isnan(tr[:, 0])]:
            print("gs %.5f  k %3d  fn %.3e" % (row[0], row[1], row[2]),
                  flush=True)
    return x, k, fn, tr


if __name__ == "__main__":
    main()
