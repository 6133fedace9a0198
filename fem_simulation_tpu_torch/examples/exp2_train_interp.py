"""exp2: train the multigrid interpolation matrix, then compare vs classic.

Port of `examples/exp2_train_interp.py` (the reference's
exp2/{P,p_hat}/quasi_simulation/main.py):

    python -m fem_simulation_tpu_torch.examples.exp2_train_interp [--mode p_hat]
"""
from __future__ import annotations

import argparse

from ..config import TrainInterpConfig
from ..models.train_interp import InterpTrainer
from ..utils.viz import plot_convergence
from ._common import beam_scene, beam_shape, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="P", choices=["P", "p_hat"])
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--unroll", type=int, default=1,
                    help="cycles unrolled in the loss (1 = the reference's "
                         "single taped cycle; >1 trains the iterated map, "
                         "see exp2_scale_run)")
    ap.add_argument("--beam", default="6,6,12")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=None,
                    help="output prefix (default: results/exp2_torch)")
    args = ap.parse_args(argv)
    out = out_path(args.out, "exp2_torch")

    scene = beam_scene(beam_shape(args.beam), device=args.device)
    tr = InterpTrainer(scene, TrainInterpConfig(mode=args.mode,
                                                unroll=args.unroll))
    hist = tr.train(args.iterations)
    print(f"loss: {hist[0]:.4e} -> {hist[-1]:.4e}")
    tr.save(f"{out}_weights.npz")

    cmp = tr.compare(iterations=5)
    plot_convergence(cmp, f"{out}_compare.png",
                     title=f"classic vs trained interpolation ({args.mode})")
    print(f"wrote {out}_weights.npz, {out}_compare.png")
    return hist, cmp


if __name__ == "__main__":
    main()
