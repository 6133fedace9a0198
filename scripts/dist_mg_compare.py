#!/usr/bin/env python3
"""The distributed lattice multigrid of one source tree on the card.

    python3 scripts/dist_mg_compare.py [--root TREE] [--out RESULT.pt]
    python3 scripts/dist_mg_compare.py --bits A.pt B.pt

On 4 z-slabs sharing the first GPU (`make_device_mesh(4, dp=1)`), with the
tree at TREE (default: this checkout) first on the import path: the
quasi-static solve from rest (3 levels, tol 1e-4, max_newton 100) of the
16x16x64 beam with every level sharded and with 8 planes a slab (the
coarsest replicated), and of the 16x16x256 beam; 16 frames of
make_dist_mg_step at 16x16x64. For each: the first run and three warm runs
in ms (CUDA events), the Newton counts, the device ops of one V-cycle
(torch.profiler) and five V-cycles' ms. Prints one JSON line; --out saves
x, Newton, ||f|| and each level's lmax for --bits, which reports whether
two saved runs are bit-equal. To compare two trees, run them in turns in
one call (parent, change, change, parent): the host sets these times.
"""
import argparse
import json
import os
import sys


def bits(a_path, b_path):
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    out = {}
    for key in a:
        ra, rb = a[key], b[key]
        out[key] = all(torch.equal(ra[n], rb[n]) if torch.is_tensor(ra[n])
                       else ra[n] == rb[n] for n in ra)
    print(json.dumps({"bit_equal": out}), flush=True)
    return 0 if all(out.values()) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), os.pardir))
    ap.add_argument("--out")
    ap.add_argument("--bits", nargs=2)
    args = ap.parse_args()
    if args.bits:
        return bits(*args.bits)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import fem_simulation_tpu_torch
    from fem_simulation_tpu_torch import mesh as meshlib
    from fem_simulation_tpu_torch.ops import _cuda
    from fem_simulation_tpu_torch.parallel import make_device_mesh
    from fem_simulation_tpu_torch.parallel import lattice_mg_dist as mgd
    from fem_simulation_tpu_torch.sim import lattice as tl
    if not fem_simulation_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {fem_simulation_tpu_torch.__file__}, "
                           f"not the tree at {root}")
    _cuda.load()
    sc = {"19k": tl.LatticeScene(meshlib.beam(16, 16, 64, dx=0.05)),
          "74k": tl.LatticeScene(meshlib.beam(16, 16, 256, dx=0.05))}
    grid = make_device_mesh(4, dp=1)

    def events(fn):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        return out, s.elapsed_time(e)

    def device_ops(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type
                   == torch.autograd.DeviceType.CUDA) / reps

    res, saved = {"root": root}, {}
    for label, scene, kw in (("19k", sc["19k"], {}),
                             ("19k8", sc["19k"], dict(min_planes_per_dev=8)),
                             ("74k", sc["74k"], {})):
        solve, place = mgd.make_dist_mg_quasistatic(
            scene, grid, n_levels=3, tol=1e-4, max_newton=100, **kw)
        (x, k, f), first = events(lambda: solve(place(scene.x0)))
        warm = [events(lambda: solve(place(scene.x0)))[1] for _ in range(3)]
        mg = solve.mg
        ops, _ = mg.newton_ops(mg.pad(scene.x0))
        b = mg.pad_cf(scene.dyn_force(scene.x0, scene.x0, 0.0))
        res[label] = dict(
            newton=k, fn=f, first_ms=first, warm_ms=warm,
            ops_per_vcycle=device_ops(lambda: mg.vcycle(ops, b)),
            vcycle_ms=[events(lambda: mg.vcycle(ops, b))[1]
                       for _ in range(5)],
            sharded=[bool(s) for s in mg.level_specs],
            shapes=[list(lv.vert_mask.shape) for lv in mg.levels])
        saved[label] = dict(x=x.cpu(), k=k, f=f,
                            lmax=[float(op.lmax) for op in ops])
    step, place = mgd.make_dist_mg_step(sc["19k"], grid, n_levels=3)

    def frames():
        st, out = place(sc["19k"].init_state()), []
        for _ in range(16):
            st, k, f = step(st)
            out.append((k, f))
        return st, out
    (st, kf), first = events(frames)
    res["frames19k"] = dict(first_ms=first / 16,
                            warm_ms=[events(frames)[1] / 16
                                     for _ in range(2)],
                            newton=[k for k, _ in kf],
                            fn_max=max(f for _, f in kf))
    saved["frames19k"] = dict(x=st.x.cpu(), v=st.v.cpu(), kf=kf)
    if args.out:
        torch.save(saved, args.out)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
