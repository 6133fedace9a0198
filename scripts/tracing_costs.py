"""What the lattice frame's spans and counters cost on the host of the card.

    python3 scripts/tracing_costs.py [--cell beam74k.frames] [--seed N]
        [--frames 100] [--blocks 8] [--json OUT]

from the root of a checkout, on a machine with a CUDA device. Three
measurements in one process, on a cell of the benchmark (`fembench/`: its
body, configuration and mix, served by its driver):

1. Off: the host time of a frame's instrumentation with tracing off, timed
   at the sites alone (timeit, a million calls a site, less the same
   statement without the instrumentation): a span site, a counter, and
   `readback` against the bare `.item()` on a CPU scalar (no sync in
   either), times the sites a frame opens (the frames' counts), plus
   `fused_newton`'s PCG counter against the two ops it replaced, on the
   card's tensors; and a span's cost with tracing on, under enable() and
   under a CUDA-only profiler.
2. On against off: blocks of the cell's frames with tracing off and with
   `profiling.enable()` (no profiler), interleaved: ms a frame a block.
3. The profiler's share of a traced frame: the mean lattice.frame span and
   frame_dispatch_us's arithmetic (the frame less its readbacks) under
   enable() alone and under a CUDA-only torch.profiler session, as the
   benchmark's first traced stretch runs it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def site_costs(n: int = 1_000_000) -> dict:
    """Host seconds a call of each off-path site, less its bare form; and a
    span's with tracing on, under enable() and under a CUDA-only
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fem_simulation_tpu_torch.sim import lattice
    from fem_simulation_tpu_torch.utils import profiling
    assert not profiling.tracing()
    env = {"span": profiling.span, "counts": lattice.counts,
           "readback": lattice.readback, "t": torch.ones(())}

    def per_call(stmt, base="pass", number=n):
        best = min(timeit.repeat(stmt, repeat=5, number=number, globals=env))
        bare = min(timeit.repeat(base, repeat=5, number=number, globals=env))
        return (best - bare) / number
    span = "with span('lattice.newton'):\n    pass"
    out = {"span": per_call(span),
           "span_request": per_call(
               "with span('lattice.frame', request=1):\n    pass"),
           "counter": per_call("counts['newton'] += 1"),
           "readback": per_call("readback(t)", "t.item()")}
    profiling.enable()
    out["span_on"] = per_call(span, number=20_000)
    profiling.disable()
    with profile(activities=[ProfilerActivity.CUDA]):
        out["span_on_cuda_profiler"] = per_call(span, number=20_000)
    profiling.reset()
    return out


def pcg_cost(dev, n: int = 20_000) -> dict:
    """Host seconds a call: the PCG counter against cg_tot + k - 1."""
    import torch
    from fem_simulation_tpu_torch.ops import lattice_kernels as lk
    k = torch.ones((), dtype=torch.int32, device=dev)
    cg = torch.zeros((), dtype=torch.int32, device=dev)
    out = {}
    for name, fn in (("pcg_counter", lambda: lk._count_pcg(k)),
                     ("cg_tot_ops", lambda: cg + k - 1)):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n
        torch.cuda.synchronize(dev)
    lk.pcg.clear()
    return out


def frame_spans(records, since_ns: int) -> tuple:
    """(mean lattice.frame span, mean frame less its readbacks), in us,
    over the frames that started after since_ns."""
    whole, waits = {}, {}
    for r in records:
        if r.start_ns < since_ns:
            continue
        if r.name == "lattice.frame":
            whole[r.request] = r.end_ns - r.start_ns
        elif r.name == "lattice.readback":
            waits[r.request] = waits.get(r.request, 0) + r.end_ns - r.start_ns
    n = max(len(whole), 1)
    return (sum(whole.values()) / n * 1e-3,
            sum(d - waits.get(i, 0) for i, d in whole.items()) / n * 1e-3,
            len(whole))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="beam74k.frames")
    ap.add_argument("--seed", type=int, default=3220000001)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fembench import geometry, meshgen, run, traffic
    from fem_simulation_tpu_torch.sim import lattice
    from fem_simulation_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    dev = torch.device("cuda:0")

    def sync():
        torch.cuda.synchronize(dev)

    cell = run.resolve(ROOT, args.cell)
    body = meshgen.body(cell.config["mesh"])
    geo = geometry.Geometry(body, cell.config["material"])
    system = run.build_system(cell, body, geo, dev, sync)
    stream = traffic.requests(cell.mix, args.seed)
    out = {"cell": args.cell, "device": torch.cuda.get_device_name(dev)}

    # 1. off, at the sites alone
    lattice.reset_counts()
    run.serve_for(system, stream, sync, count=args.frames)
    c = dict(lattice.counts)
    per = site_costs()
    per.update(pcg_cost(dev))
    frames = c["frames"]
    sites = {"span": frames + c["newton"] + c["rescues"],   # setup, newton, rescue
             "span_request": frames,                        # the frame
             "counter": frames + c["newton"] + c["rescues"],
             "readback": c["syncs"]}
    off_us = sum(per[k] * n for k, n in sites.items()) / frames * 1e6
    pcg_us = (per["pcg_counter"] - per["cg_tot_ops"]) * c["newton"] / frames * 1e6
    out.update(site_s=per, counts=c, sites_a_frame={
        k: n / frames for k, n in sites.items()},
        off_us_a_frame=off_us, pcg_counter_less_cg_tot_us_a_frame=pcg_us)
    print(f"off: {off_us:.3f} us a frame at the span sites and counters "
          f"({ {k: round(v * 1e9, 1) for k, v in per.items()} } ns a call; "
          f"sites a frame { {k: round(n / frames, 3) for k, n in sites.items()} }); "
          f"the PCG counter less the cg_tot ops it replaced "
          f"{pcg_us:+.3f} us a frame", flush=True)

    # 2. on against off, interleaved blocks
    ms = {"off": [], "on": []}
    for b in range(2 * args.blocks):
        side = ("off", "on")[(b + b // 2) % 2]     # off on on off off on ...
        if side == "on":
            profiling.enable()
        recs, wall = run.serve_for(system, stream, sync, count=args.frames)
        profiling.disable()
        ms[side].append(wall * 1e3 / len(recs))
    med = {k: statistics.median(v) for k, v in ms.items()}
    out.update(block_ms=ms, median_ms=med,
               on_less_off_us=(med["on"] - med["off"]) * 1e3)
    print(f"on against off: ms a frame off {med['off']:.4f} on "
          f"{med['on']:.4f} ({(med['on'] - med['off']) * 1e3:+.1f} us a frame; "
          f"blocks off {[round(v, 4) for v in ms['off']]} on "
          f"{[round(v, 4) for v in ms['on']]})", flush=True)

    # 3. the profiler's share of a traced frame
    with profile(activities=[ProfilerActivity.CUDA]):     # its start-up
        run.serve_for(system, stream, sync, count=1)
    res = {}
    for side in ("enable", "profiler", "enable", "profiler"):
        t0 = time.monotonic_ns()
        if side == "enable":
            profiling.enable()
            run.serve_for(system, stream, sync, count=args.frames)
            profiling.disable()
        else:
            with profile(activities=[ProfilerActivity.CUDA]):
                run.serve_for(system, stream, sync, count=args.frames)
        res.setdefault(side, []).append(frame_spans(profiling.records(), t0))
    out["frame_spans_us"] = res
    for side, vals in res.items():
        print(f"{side}: lattice.frame {[round(v[0], 1) for v in vals]} us, "
              f"less its readbacks {[round(v[1], 1) for v in vals]} us "
              f"({[v[2] for v in vals]} frames)", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
