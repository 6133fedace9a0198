"""exp1 dynamic: implicit-Euler frames with a scripted drag, as a GIF.

Port of `examples/exp1_dynamic.py` (the reference's exp1/simulation/main.py,
`win.loop(obj.render)`), headless: runs frames, clicks and drags the mesh
through the picker, writes a GIF.

    python -m fem_simulation_tpu_torch.examples.exp1_dynamic [--frames 60]

--beam and --device are added here.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import mesh as meshlib
from ..config import SolverConfig
from ..render import HeadlessWindow
from ..sim import Scene
from ..sim.dynamic import DynamicSim
from ..sim.picking import Picker
from ._common import beam_shape, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dx", type=float, default=0.05)
    ap.add_argument("--beam", default="8,8,24")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--gif", default=None,
                    help="output (default: results/dynamic_torch.gif)")
    args = ap.parse_args(argv)
    gif = out_path(args.gif, "dynamic_torch.gif")

    m = meshlib.load_hex_mesh(args.mesh, args.dx,
                              beam_shape=beam_shape(args.beam))
    scene = Scene(m, solver=SolverConfig(), device=args.device)
    sim = DynamicSim(scene)
    tris = meshlib.surface_triangles(m.hexes)
    picker = Picker(sim, tris, grab_radius2=0.02)

    win = HeadlessWindow(640, 640)
    win.camera.position = m.x.mean(axis=0) + np.array([0.0, 0.3, 2.0])
    win.camera.target = m.x.mean(axis=0)
    win.set_frame_source(lambda: (scene.to_mesh_order(sim.state.x), tris))
    win.setSelect(picker.select, picker.move_select, picker.clear)

    def render(pause):
        if not pause:
            sim.frame()

    # scripted interaction: click + drag mid-run, release near the end
    win.inject_click(320, 320)
    win.inject_drag(320, 280)
    win.loop(render, max_frames=args.frames, capture_every=2)
    win.inject_release()

    win.save_gif(gif)
    print(f"wrote {gif} ({len(win.frames)} frames)")
    return sim


if __name__ == "__main__":
    main()
