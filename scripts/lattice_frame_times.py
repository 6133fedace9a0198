#!/usr/bin/env python3
"""Time the PyTorch port's lattice main path on one GPU, run after run.

    python3 scripts/lattice_frame_times.py [--root TREE] [--repeats 5]

Runs chip_smoke.py's phase-2 protocol (LatticeScene of the 8x8x24,
16x16x64 and 16x16x256 beams at dx 0.05; 48 excited frames from rest to
||f||_inf <= 1e-4, gravity scaled by cos(2 pi t / 16), dt 0.033,
max_newton 20, cg 60 / 1e-2) `--repeats` times per beam after two warm-up
frames, and prints ms/frame (CUDA events) of every run and their median,
then one JSON line. With `--profile`, one more run of the 48 frames per
beam is traced with torch.profiler: host ms/frame, device busy ms/frame
(union of the kernel and memory-op intervals), the idle share and the
fused Newton kernel's launches and mean device time. `--root` names the checkout whose
`fem_simulation_tpu_torch` is timed (default: this one), so that one call
on the card can alternate two checkouts, each in its own process. The beam
meshes come from this checkout's `mesh.py`, loaded by file path.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEAMS = {"2k": (8, 8, 24), "19k": (16, 16, 64), "74k": (16, 16, 256)}
FRAMES = 48


def beam_mesh(shape):
    spec = importlib.util.spec_from_file_location(
        "_beam_mesh", os.path.join(HERE, "fem_simulation_tpu_torch", "mesh.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod            # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod.beam(*shape, dx=0.05)


def traced(run):
    """Host ms, device busy ms and idle share per frame of run() (FRAMES
    frames) under torch.profiler; the fused Newton kernel's launches and
    mean device us."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    evs = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((s, e) for _, s, e in evs):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    newton = [e - s for name, s, e in evs if "fused_newton_kernel" in name]
    return dict(host_ms_per_frame=wall / FRAMES,
                device_busy_ms_per_frame=busy / 1e3 / FRAMES,
                idle_share=1.0 - busy / 1e3 / wall,
                device_ops_per_frame=len(evs) / FRAMES,
                fused_newton_launches=len(newton),
                fused_newton_us=float(np.mean(newton)) if newton else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from fem_simulation_tpu_torch.sim import lattice as tlat
    if not torch.cuda.is_available():
        print("lattice_frame_times: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()

    def frames(sc, n):
        st = sc.init_state()
        ks = []
        for i in range(n):
            g = float(np.cos(np.float32(2.0 * np.pi) * np.float32(i)
                             / np.float32(16.0)))
            st, k, fn, _ = tlat.step_to_tol(sc, st, tol=1e-4, max_newton=20,
                                            cg_iterations=60, cg_tol=1e-2,
                                            gravity_scale=g, return_cg=True)
            ks.append(k)
        return ks

    out = {"root": os.path.abspath(args.root), "card": card}
    for label, shape in BEAMS.items():
        sc = tlat.LatticeScene(beam_mesh(shape), device="cuda")
        frames(sc, 2)
        runs = []
        for _ in range(args.repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            ks = frames(sc, FRAMES)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / FRAMES)
        out[label] = dict(ms_per_frame=runs, median=float(np.median(runs)),
                          newton=int(sum(ks)))
        print(f"{label:4s} ms/frame " + " ".join(f"{r:.3f}" for r in runs)
              + f"  median {np.median(runs):.3f}  newton {sum(ks)}",
              flush=True)
        if args.profile:
            out[label]["profile"] = traced(lambda: frames(sc, FRAMES))
            print(f"{label:4s} profile " + json.dumps(out[label]["profile"]),
                  flush=True)
    print(card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
