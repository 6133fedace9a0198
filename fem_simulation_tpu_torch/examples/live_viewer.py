"""Live viewer: the reference's GLFW demo loop, in a browser.

Port of `examples/live_viewer.py` (the reference's exp1/simulation/main.py:
window, mouse select and drag, Space pauses) for a host with no GL: the
dynamic FEM sim steps continuously on the device while a localhost page
renders the surface and feeds mouse drags back into the solver's drag
constraints (render/live.py).

    python -m fem_simulation_tpu_torch.examples.live_viewer [--mesh kitten.obj --dx 0.04]

then open the printed URL. LMB on the mesh drags it; LMB elsewhere orbits;
the wheel zooms; Space pauses. --device and --seconds (serve that long,
then stop; 0, the default, serves until Ctrl-C) are added here.
"""
from __future__ import annotations

import argparse
import time

from .. import mesh as meshlib
from ..config import SolverConfig
from ..render.live import LiveViewer
from ..sim import Scene
from ..sim.dynamic import DynamicSim
from ._common import beam_shape


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dx", type=float, default=0.05)
    ap.add_argument("--beam", default="8,8,24")
    ap.add_argument("--port", type=int, default=8799)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    m = meshlib.load_hex_mesh(args.mesh, args.dx,
                              beam_shape=beam_shape(args.beam),
                              normalize=args.mesh is not None)
    scene = Scene(m, solver=SolverConfig(n_levels=2), device=args.device)
    sim = DynamicSim(scene)
    viewer = LiveViewer(sim, meshlib.surface_triangles(m.hexes),
                        port=args.port)
    url = viewer.start()
    print(f"live viewer on {url}  ({m.n_verts} verts): Ctrl-C to stop",
          flush=True)
    try:
        if args.seconds > 0:
            time.sleep(args.seconds)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()
    return viewer


if __name__ == "__main__":
    main()
