"""exp3: train a GNN to replace the implicit solve, then roll it out.

Port of `examples/exp3_learned_solver.py` (the reference's
exp3/simulation/main.py, train + test_render):

    python -m fem_simulation_tpu_torch.examples.exp3_learned_solver [--multilevel]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..config import TrainSolverConfig
from ..models.train_solver import SolverNetTrainer
from ..sim import dynamic
from ._common import beam_scene, beam_shape, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--train-iters", type=int, default=2000)
    ap.add_argument("--multilevel", action="store_true")
    ap.add_argument("--absolute", action="store_true",
                    help="regress absolute x (reference parity) instead of dx")
    ap.add_argument("--rollout-frames", type=int, default=30)
    ap.add_argument("--beam", default="4,4,8")
    ap.add_argument("--dx", type=float, default=0.1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--model-out", default=None,
                    help="weights file (default: results/exp3_model_torch.npz)")
    args = ap.parse_args(argv)
    model_out = out_path(args.model_out, "exp3_model_torch.npz")

    scene = beam_scene(beam_shape(args.beam), dx=args.dx, device=args.device)
    cfg = TrainSolverConfig(frames=args.frames)
    tr = SolverNetTrainer(scene, cfg, multilevel=args.multilevel,
                          predict_delta=not args.absolute)
    losses = tr.train(iterations=args.train_iters)
    print(f"MSE: {losses[:10].mean():.3e} -> {losses[-10:].mean():.3e}")
    tr.save(model_out)

    # learned rollout: the net replaces the solver per frame (test_render)
    st = dynamic.init_state(scene)
    res = []
    for _ in range(args.rollout_frames):
        st = tr.learned_step(st)
        res.append(tr.evaluate_residual(st.x, st))
    print("learned-stepper residual inf-norms:",
          np.asarray(res)[:5], "...", np.asarray(res)[-3:])
    return losses, np.asarray(res)


if __name__ == "__main__":
    main()
