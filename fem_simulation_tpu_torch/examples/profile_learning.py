"""Where a training step's time goes on the PyTorch port's learning path,
on one GPU.

    python -m fem_simulation_tpu_torch.examples.profile_learning [--beam 16,16,72] [--reps 5]

On the exp2 / exp3 drivers' beam (dx 0.05, 2 levels) it times, with CUDA
events after a warm-up, exp2's loss-and-gradient (InterpTrainer, mode p_hat,
l2, unroll 4) and one MDN3 Adam step (mse, on frame 1 of a 4-frame rollout),
then traces one of each with torch.profiler: device ops, device busy time
(the sum of the kernel and memory-op spans), idle share and the kernels
that take the most device time. One JSON object per line; the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from .. import mesh as meshlib
from .. import require_cuda
from ..config import SolverConfig, TrainInterpConfig, TrainSolverConfig
from ..models import train_interp as ti
from ..models import train_solver as ts
from ..sim.scene import Scene


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace(fn):
    """(device ops, busy ms, [(kernel, launches, ms)] top 4) of one call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.name, []).append(
                (e.time_range.end - e.time_range.start) * 1e-3)
    busy = sum(sum(v) for v in spans.values())
    top = sorted(spans.items(), key=lambda kv: -sum(kv[1]))[:4]
    return (sum(len(v) for v in spans.values()), busy,
            [(name[:60], len(v), round(sum(v), 3)) for name, v in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--beam", default="16,16,72")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    shape = tuple(int(s) for s in args.beam.split(","))
    sc = Scene(meshlib.beam(*shape, dx=0.05), solver=SolverConfig(n_levels=2),
               device=dev)
    tr = ti.InterpTrainer(sc, TrainInterpConfig(mode="p_hat", loss="l2",
                                                unroll=4))
    _, vids, deltas = tr.schedule(1)
    x = sc.x0.clone()
    x[int(vids[0])] += torch.from_numpy(deltas[0]).to(dev)
    net = ts.SolverNetTrainer(sc, TrainSolverConfig(frames=4),
                              predict_delta=True)
    net.init(0)
    xt, xs, _ = ts.generate_rollout(sc, TrainSolverConfig(frames=4))
    opt = torch.optim.Adam(net.model.parameters(), lr=1e-3)

    def mdn3_step():
        opt.zero_grad(set_to_none=True)
        net.loss_fn(xt[1], xs[1]).backward()
        opt.step()

    steps = {"exp2 loss_and_grad": lambda: tr.loss_and_grad(tr.w, x),
             "exp3 MDN3 Adam step": mdn3_step}
    for name, fn in steps.items():
        ms = events_ms(fn, args.reps)
        ops, busy, top = trace(fn)
        print(json.dumps({"step": name, "ms": ms, "device_ops": ops,
                          "busy_ms": busy, "idle_share": 1.0 - busy / ms,
                          "top": top}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
