"""exp2 at reference scale: >= 1,000 training steps on a >= 19k-vertex mesh.

Port of `examples/exp2_scale_run.py`: the 16x16x72 beam (17x17x73 =
21,097 vertices, 2 levels), mode p_hat, l2 loss, unroll 4, Adam. Writes the
trained weights, the loss history, the classic-vs-trained compare plot and
a metrics row:

    python -m fem_simulation_tpu_torch.examples.exp2_scale_run [--iterations 1000]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import TrainInterpConfig
from ..models.train_interp import InterpTrainer
from ..utils.io import MetricsLogger
from ..utils.viz import plot_convergence
from ._common import beam_scene, beam_shape, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="p_hat", choices=["P", "p_hat"],
                    help="p_hat (default) trains the position-side "
                         "restriction, whose trained bare cycle stays "
                         "contractive when iterated; P the residual transfer")
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--optimizer", default="adam", choices=["sgd", "adam"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--unroll", type=int, default=4,
                    help="cycles unrolled in the loss (1 = the reference's "
                         "single taped cycle)")
    ap.add_argument("--beam", default="16,16,72",
                    help="17x17x73 = 21k vertices, the reference demo scale")
    ap.add_argument("--project-rows", action="store_true",
                    help="hard partition-of-unity projection after every "
                         "update")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = out_path(args.out, f"exp2_scale_{args.mode}_torch")

    shape = beam_shape(args.beam)
    scene = beam_scene(shape, device=args.device)
    n = scene.level(0).n_verts
    print(f"mesh: beam{shape} = {n} verts on {scene.device}", flush=True)

    tr = InterpTrainer(scene, TrainInterpConfig(
        mode=args.mode, loss="l2", optimizer=args.optimizer, lr=args.lr,
        unroll=args.unroll, project_rows=args.project_rows))
    t0 = time.perf_counter()
    hist = tr.train(args.iterations)     # reads its history back: synced
    t1 = time.perf_counter()
    h = tr.history
    print(f"train: {args.iterations} steps in {t1 - t0:.1f} s "
          f"(loss {hist[0]:.4e} -> {hist[-1]:.4e}; "
          f"data {h['data'][0]:.4e} -> {h['data'][-1]:.4e}; "
          f"penalty {h['penalty'][0]:.4e} -> {h['penalty'][-1]:.4e})",
          flush=True)
    print("fixed-probe residual series (bare trained cycle iterated from "
          "one held-out state):", flush=True)
    for s, r in zip(h["probe_steps"], h["probe_resid"]):
        print(f"  step {int(s):5d}: {r:.4e}", flush=True)
    tr.save(f"{out}_weights.npz")
    np.savez(f"{out}_history.npz", **h)

    rigid = tr.rigid_transfer_error()
    print(f"rigid-mode transfer error (max |row_sum - 1|): {rigid:.3e}",
          flush=True)
    cmp = tr.compare(iterations=8)
    plot_convergence(cmp, f"{out}_compare.png",
                     title=f"classic vs trained interpolation "
                           f"({args.mode}, {n} verts)")
    log = MetricsLogger(csv_path=f"{out}_metrics.csv")
    log.log(0, n_verts=n, iterations=args.iterations,
            seconds=t1 - t0, loss_first=float(hist[0]),
            loss_last=float(hist[-1]),
            data_first=float(h["data"][0]), data_last=float(h["data"][-1]),
            penalty_first=float(h["penalty"][0]),
            penalty_last=float(h["penalty"][-1]),
            probe_first=float(h["probe_resid"][0]),
            probe_last=float(h["probe_resid"][-1]),
            rigid_err=rigid, project_rows=int(args.project_rows),
            classic_last=float(cmp["classic"][-1]),
            trained_last=float(cmp["trained"][-1]))
    log.close()
    print("classic residuals:", cmp["classic"], flush=True)
    print("trained residuals:", cmp["trained"], flush=True)
    device = (torch.cuda.get_device_name(scene.device)
              if scene.device.type == "cuda" else "cpu")
    print(f"device: {device}; wrote {out}_weights.npz, {out}_compare.png, "
          f"{out}_metrics.csv")
    if not cmp["trained"][-1] < cmp["classic"][-1]:
        raise SystemExit("trained transfer must beat classic at scale")
    return tr, cmp


if __name__ == "__main__":
    main()
