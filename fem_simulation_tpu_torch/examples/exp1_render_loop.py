"""exp1 quasi-static render loop: one two-level cycle per frame, as a GIF.

Port of `examples/exp1_render_loop.py` (the reference's quasi-static
interactive demo, exp1/quasi_simulation/object.py `render`): every frame
runs one FAS v3 cycle (`sim.quasistatic.fas_step`, variant 3) so the mesh
visibly relaxes toward equilibrium across frames. Headless: writes a GIF of
the relaxation and prints the ||f||_inf series' ends.

    python -m fem_simulation_tpu_torch.examples.exp1_render_loop [--frames 90]

--device is added here.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import mesh as meshlib
from ..config import SolverConfig
from ..ops import ell
from ..render import HeadlessWindow
from ..sim import Scene
from ..sim.quasistatic import fas_step, total_force
from ._common import beam_shape, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dx", type=float, default=0.05)
    ap.add_argument("--beam", default="8,8,24")
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--gif", default=None,
                    help="output (default: results/render_loop_torch.gif)")
    args = ap.parse_args(argv)
    gif = out_path(args.gif, "render_loop_torch.gif")

    m = meshlib.load_hex_mesh(args.mesh, args.dx,
                              beam_shape=beam_shape(args.beam))
    scene = Scene(m, solver=SolverConfig(n_levels=2), device=args.device)
    tris = meshlib.surface_triangles(m.hexes)

    win = HeadlessWindow(480, 480)
    win.camera.position = m.x.mean(axis=0) + np.array([0.0, 0.3, 2.2])
    win.camera.target = m.x.mean(axis=0)
    state = {"x": scene.x0, "fn": []}
    win.set_frame_source(lambda: (scene.to_mesh_order(state["x"]), tris))

    def render(pause):
        if not pause:
            state["x"], f = fas_step(scene, scene.params, state["x"],
                                     variant=3)
            state["fn"].append(float(ell.inf_norm(f)))

    win.loop(render, max_frames=args.frames, capture_every=3)
    win.save_gif(gif)

    fn_final = float(ell.inf_norm(total_force(scene, scene.params,
                                              state["x"])))
    print(f"wrote {gif} ({len(win.frames)} frames); "
          f"||f||inf {state['fn'][0]:.3e} -> {fn_final:.3e} "
          f"after {args.frames} per-frame cycles")
    return np.asarray(state["fn"]), fn_final


if __name__ == "__main__":
    main()
