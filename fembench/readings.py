"""The readings a cell's check limit is set from, in one process.

    python3 -m fembench.readings --workload <cell> --seeds <n> --seconds <s>
        [--control-seeds <n>] [--control-requests <n>] [--first-seed <n>]

The benchmark's runs do not run this. It builds the cell's program once and
serves, for each of `--seeds` seeds, the window a run would (`--seconds`
of the seed's requests), then judges that window's sample and hardest
answer as a run does: the program's readings, whose largest is the lower
end of the limit. Then it puts the control in the program's place, the
reference's own Newton solver computed in TF32 (reference.Model with
prec 'tf32'), and judges `--control-requests` of its answers for each of
`--control-seeds` seeds the same way: the control's readings, whose
smallest is the upper end. One JSON line a seed on standard output.

`--device cpu` runs it at whatever size the cell's configuration gives, on
the program's plain versions (the tests do, on tiny cells).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def readings(root: str, workload: str, seeds, seconds: float,
             control_seeds=(), control_requests: int = 8,
             device: str = "cuda", emit=print):
    import torch

    torch.set_num_threads(1)
    from . import geometry, meshgen, run, traffic
    from .reference import Model

    cell = run.resolve(root, workload)
    cfg, mix = cell.config, cell.mix
    cuda = device != "cpu"
    dev = torch.device("cuda:0" if cuda else "cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    body = meshgen.body(cfg["mesh"])
    geo = geometry.Geometry(body, cfg["material"])
    system = run.build_system(cell, body, geo, dev, sync)
    judge_model = Model(geo, cfg["material"], dev, dtype=torch.float64)
    out = []

    def one(who, seed, **kw):
        sampler = run.Sampler(int(mix["sample"]), seed)
        t0 = time.perf_counter()
        recs, wall = run.serve_for(system, traffic.requests(mix, seed), sync,
                                   on_answer=sampler.offer, **kw)
        vals = [cell.driver.judge(judge_model, a, cfg, mix)
                for a in sampler.answers()]
        line = {"workload": workload, "who": who, "seed": seed,
                "resid_max": max(vals), "judged": len(vals),
                "requests": len(recs), "window_s": wall,
                "newton_max": max(k for k, _, _ in recs),
                "newton_mean": sum(k for k, _, _ in recs) / len(recs),
                "ms_mean": sum(ms for _, _, ms in recs) / len(recs),
                "above_tol": sum(1 for _, fn, _ in recs
                                 if not fn <= float(mix["tol"])),
                "seconds": time.perf_counter() - t0}
        emit(json.dumps(line))
        out.append(line)

    for seed in seeds:
        one("program", seed, until=seconds)
    if control_seeds:
        ctrl = Model(geo, cfg["material"], dev, dtype=torch.float32,
                     prec="tf32")
        system.step = cell.driver.reference_step(ctrl)
        for seed in control_seeds:
            one("control", seed, count=control_requests)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=1000003)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--control-requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    cseeds = [args.first_seed + 104729 * (i + 1)
              for i in range(args.control_seeds)]
    readings(os.getcwd(), args.workload, seeds, args.seconds, cseeds,
             args.control_requests, args.device,
             emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
