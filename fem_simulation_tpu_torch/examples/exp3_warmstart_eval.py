"""exp3's learned solver as a WARM START: Newton iterations and ms a frame
of `step_to_tol` seeded at the net prediction against the plain inertia
predictor, over a held-out rollout at the trained scale (the trajectory
advances with the plain solution, so both solvers face the same problem
every frame).

Port of `examples/exp3_warmstart_eval.py`; run after exp3_scale_run:

    python -m fem_simulation_tpu_torch.examples.exp3_warmstart_eval [--net results/exp3_scale_torch_net.npz]
"""
from __future__ import annotations

import argparse
import os

from ..config import TrainSolverConfig
from ..models.train_solver import SolverNetTrainer
from ..utils.io import MetricsLogger
from ._common import RESULTS, beam_scene, beam_shape, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default=os.path.join(RESULTS,
                                                  "exp3_scale_torch_net.npz"))
    ap.add_argument("--beam", default="16,16,72",
                    help="must match the training mesh")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--multilevel", action="store_true",
                    help="the net at --net is a MultiLevel3")
    ap.add_argument("--seed", type=int, default=123,
                    help="held-out rollout seed (training used 0)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = out_path(args.out, "exp3_warmstart"
                   + ("_ml" if args.multilevel else "") + "_torch")

    shape = beam_shape(args.beam)
    scene = beam_scene(shape, device=args.device)
    print(f"mesh: beam{shape} = {scene.level(0).n_verts} verts on "
          f"{scene.device}", flush=True)
    tr = SolverNetTrainer(scene, TrainSolverConfig(),
                          multilevel=args.multilevel, predict_delta=True)
    tr.load(args.net)

    stats = tr.warmstart_stats(frames=args.frames, seed=args.seed)
    k_p, k_w = stats["k_plain"], stats["k_warm"]
    print("per-frame Newton (plain):", k_p.tolist(), flush=True)
    print("per-frame Newton (warm): ", k_w.tolist(), flush=True)
    print(f"total Newton: plain {int(k_p.sum())} vs warm {int(k_w.sum())} "
          f"({int(k_p.sum()) - int(k_w.sum())} saved, "
          f"{100 * (1 - k_w.sum() / max(k_p.sum(), 1)):.1f}%)", flush=True)
    print(f"ms/frame: plain {stats['ms_plain']:.2f} vs warm "
          f"{stats['ms_warm']:.2f} (incl. net forward)", flush=True)
    print(f"worst frame residual: plain {stats['fn_plain'].max():.2e} "
          f"warm {stats['fn_warm'].max():.2e}", flush=True)

    log = MetricsLogger(csv_path=f"{out}_metrics.csv")
    log.log(0, n_verts=scene.level(0).n_verts, frames=args.frames,
            seed=args.seed,
            newton_plain=int(k_p.sum()), newton_warm=int(k_w.sum()),
            newton_saved_pct=float(100 * (1 - k_w.sum()
                                          / max(k_p.sum(), 1))),
            ms_plain=float(stats["ms_plain"]),
            ms_warm=float(stats["ms_warm"]),
            fn_worst_plain=float(stats["fn_plain"].max()),
            fn_worst_warm=float(stats["fn_warm"].max()))
    log.close()
    print(f"wrote {out}_metrics.csv")
    return stats


if __name__ == "__main__":
    main()
