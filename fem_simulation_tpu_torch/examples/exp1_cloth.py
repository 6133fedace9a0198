"""exp1 cloth: the mass-spring cloth, two corners pinned, as a GIF.

Port of `examples/exp1_cloth.py` (the reference's
exp1/cloth_simulation/main.py).

    python -m fem_simulation_tpu_torch.examples.exp1_cloth [--res 64]

--device is added here.
"""
from __future__ import annotations

import argparse

from ..config import ClothConfig
from ..sim.cloth import ClothSim
from ..utils.viz import render_gif
from ._common import out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--gif", default=None,
                    help="output (default: results/cloth_torch.gif)")
    args = ap.parse_args(argv)
    gif = out_path(args.gif, "cloth_torch.gif")

    cfg = ClothConfig(res_x=args.res, res_y=args.res)
    sim = ClothSim(cfg, pins=[0, args.res], device=args.device)
    frames = []
    for i in range(args.frames):
        st = sim.frame()
        if i % 4 == 0:
            frames.append(st.x.detach().cpu().numpy().copy())
    y = st.x[:, 1]
    print("cloth:", tuple(st.x.shape), "final y-range", float(y.min()),
          float(y.max()))
    render_gif(frames, sim.triangles(), gif)
    print(f"wrote {gif}")
    return st


if __name__ == "__main__":
    main()
