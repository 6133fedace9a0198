"""exp3 at reference scale: 20,000 training iterations over 30-frame
rollouts on a >= 19k-vertex mesh (the reference's hyperparameters,
train_times=20000, frames=30).

Port of `examples/exp3_scale_run.py`. Writes the net weights, the loss
curve and the reference's quality metric: the residual inf-norm of the net
prediction used AS the implicit-step solution, beside the solver's:

    python -m fem_simulation_tpu_torch.examples.exp3_scale_run [--loss residual]
"""
from __future__ import annotations

import argparse
import time

from ..config import DynamicsConfig, TrainSolverConfig
from ..models.train_solver import SolverNetTrainer
from ..sim import dynamic
from ..utils.io import MetricsLogger
from ..utils.viz import plot_convergence
from ._common import beam_scene, beam_shape, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=20000)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--beam", default="16,16,72",
                    help="17x17x73 = 21k vertices, the reference demo scale")
    ap.add_argument("--multilevel", action="store_true")
    ap.add_argument("--loss", default="mse", choices=["mse", "residual"],
                    help="mse = reference parity (||pred - x*||^2); "
                         "residual = the implicit-step force residual of "
                         "the prediction (the eval metric)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = out_path(args.out, "exp3_scale"
                   + ("_ml" if args.multilevel else "")
                   + ("_resloss" if args.loss == "residual" else "")
                   + "_torch")

    shape = beam_shape(args.beam)
    scene = beam_scene(shape, device=args.device)
    n = scene.level(0).n_verts
    print(f"mesh: beam{shape} = {n} verts on {scene.device}", flush=True)

    cfg = TrainSolverConfig(frames=args.frames, train_times=args.iterations,
                            loss=args.loss)
    tr = SolverNetTrainer(scene, cfg, multilevel=args.multilevel,
                          predict_delta=True)
    t0 = time.perf_counter()
    losses = tr.train(args.iterations)   # reads its losses back: synced
    t1 = time.perf_counter()
    print(f"train: {args.iterations} iters / {args.frames} frames in "
          f"{t1 - t0:.1f} s (loss {losses[0]:.3e} -> {losses[-1]:.3e})",
          flush=True)
    tr.save(f"{out}_net.npz")
    plot_convergence({args.loss: losses[:: max(len(losses) // 2000, 1)]},
                     f"{out}_loss.png", xlabel="iteration (subsampled)",
                     title=f"exp3 training, {n} verts")

    # net vs solver on a fresh frame: 3 solver frames from rest, then the
    # net's one-shot prediction of the next frame
    st = dynamic.init_state(scene)
    for _ in range(3):
        st, k, fn = dynamic.step_to_tol(scene, scene.params, st, tol=1e-4,
                                        max_newton=10)
    solver_resid = float(fn)
    dyn = DynamicsConfig()
    x_tilde = st.x + st.v * dyn.damping * dyn.dt
    net_resid = tr.evaluate_residual(x_tilde, st)
    print(f"residual inf-norm: solver {solver_resid:.3e} "
          f"vs net one-shot {net_resid:.3e}", flush=True)

    log = MetricsLogger(csv_path=f"{out}_metrics.csv")
    log.log(0, n_verts=n, iterations=args.iterations, frames=args.frames,
            seconds=t1 - t0, loss_first=float(losses[0]),
            loss_last=float(losses[-1]), solver_resid=solver_resid,
            net_resid=net_resid)
    log.close()
    print(f"wrote {out}_net.npz, {out}_loss.png, {out}_metrics.csv")
    return losses, solver_resid, net_resid


if __name__ == "__main__":
    main()
