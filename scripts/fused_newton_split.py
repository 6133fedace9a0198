#!/usr/bin/env python3
"""Split a benchmark cell's fused Newton launches into phases, on one GPU.

    python3 scripts/fused_newton_split.py [--cell CELL] [--against TREE]
        [--seed N] [--frames N] [--reps N] [--out DIR] [--json FILE]

Serves the first `--frames` frames of an episode of the benchmark's cell
CELL (fembench's configuration, mix and driver; default `shell64.frames`,
the 64^3 shell under its cover; `beam74k.frames` runs the dense form) and
keeps the inputs of every `lattice_kernels.fused_newton` call. Then it runs
those calls again through

* this tree's kernel library and, with --against, the library of the tree
  TREE (its `csrc/` and `ops/_cuda.py`, copied and built under DIR),
  interleaved call by call, `--reps` times: device µs a launch by CUDA
  events, and the bits of dx, f, fn and k of every call against this
  tree's (equal as torch.equal takes them, and equal to the bit, the sign
  of zero included);
* a copy of each library built under DIR (default `.scratch/fused_newton_split`
  in this checkout) with clock64() stamps at the phase boundaries of
  `fused_newton_kernel`: each block's cycles a launch split into the cell
  passes (with the inactive tiles' zeroing), the vector phases (the PCG's
  set-up and update loops) and the rest (block reductions and grid
  barriers, waits for the slowest block included), the mean over blocks,
  shown in µs at the library's own time a launch. The stamps' copy must
  give the same bits as its library.

Prints a table and writes it to FILE as JSON where --json is given. Exits 1
where a check fails.
"""
import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import os
import shutil
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from fembench import geometry, meshgen, run as fbrun, traffic  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import lattice_kernels as lk  # noqa: E402

CATEGORIES = ("cell passes", "vector phases", "reductions and barriers")
SPLIT_BLOCKS = 1024

# The stamps, put after the includes of csrc/lattice_kernels.cu.
STAMPS = r"""
__device__ long long g_split[1024 * 4];
__device__ long long g_split_last[1024];
__device__ __forceinline__ void split_start() {
    if (threadIdx.x == 0 && blockIdx.x < 1024) {
        g_split_last[blockIdx.x] = clock64();
        g_split[blockIdx.x * 4 + 3] += 1;
    }
}
// every thread of the block calls it, at a block-uniform point
__device__ __forceinline__ void split_mark(int cat) {
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.x < 1024) {
        const long long t = clock64();
        g_split[blockIdx.x * 4 + cat] += t - g_split_last[blockIdx.x];
        g_split_last[blockIdx.x] = t;
    }
}
"""
READER = r"""
extern "C" int fn_split_read(long long* out) {
    return cudaMemcpyFromSymbol(out, g_split, sizeof(long long) * 1024 * 4);
}
extern "C" int fn_split_reset() {
    static long long zeros[1024 * 4];
    return cudaMemcpyToSymbol(g_split, zeros, sizeof(zeros));
}
"""


def _sub(text, old, new, count):
    """text with each of `count` occurrences of old replaced by new."""
    if text.count(old) != count:
        raise RuntimeError(f"expected {count} of {old!r}, found "
                           f"{text.count(old)}")
    return text.replace(old, new)


def stamped(source: str) -> str:
    """csrc/lattice_kernels.cu with the stamps in fused_newton_kernel and in
    cell_vertex_pass (exchange tiles: the cell pass, its grid barrier, the
    owners' vertex pass)."""
    text = _sub(source, "namespace cg = cooperative_groups;\n",
                "namespace cg = cooperative_groups;\n" + STAMPS, 1)
    # cell_vertex_pass: its barrier apart, its end marked
    text = _sub(text, "    if (P.T.halo) return;\n    grid.sync();\n",
                "    if (P.T.halo) { split_mark(0); return; }\n"
                "    split_mark(0);\n    grid.sync();\n    split_mark(2);\n",
                1)
    text = _sub(text, "        tile_done(tile_id(P.T, j));\n    }\n}\n",
                "        tile_done(tile_id(P.T, j));\n    }\n"
                "    split_mark(0);\n}\n", 1)
    head = "fused_newton_kernel(const __grid_constant__ NewtonArgs P) {"
    a = text.index(head)
    b = text.index("// A tile's width in vertices", a)
    body = text[a:b]
    body = _sub(body, "    const int ntiles = P.T.ntx * P.T.nty * P.T.ntz;\n",
                "    const int ntiles = P.T.ntx * P.T.nty * P.T.ntz;\n"
                "    split_start();\n", 1)
    body = _sub(body, "block_sum2(a_rz, a_rr, sh);",
                "split_mark(1);\n    block_sum2(a_rz, a_rr, sh);", 2)
    body = _sub(body, "grid.sync();", "grid.sync();\n    split_mark(2);", 5)
    return text[:a] + body + text[b:] + READER


def load_cuda_module(tree: str, name: str):
    """The ops/_cuda.py of `tree` as a module of its own (its library is
    built from, and into, that tree's package)."""
    path = os.path.join(tree, "fem_simulation_tpu_torch", "ops", "_cuda.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def library_copy(tree: str, out: str, label: str, stamps: bool):
    """`tree`'s library (its csrc/ and ops/_cuda.py) copied under
    out/label and built there, with the stamps where `stamps`: nothing is
    written into `tree`."""
    pkg = os.path.join(out, label, "fem_simulation_tpu_torch")
    shutil.rmtree(os.path.join(pkg, "csrc"), ignore_errors=True)
    shutil.copytree(os.path.join(tree, "fem_simulation_tpu_torch", "csrc"),
                    os.path.join(pkg, "csrc"))
    os.makedirs(os.path.join(pkg, "ops"), exist_ok=True)
    shutil.copy(os.path.join(tree, "fem_simulation_tpu_torch", "ops",
                             "_cuda.py"), os.path.join(pkg, "ops"))
    if stamps:
        src = os.path.join(pkg, "csrc", "lattice_kernels.cu")
        with open(src) as fh:
            text = stamped(fh.read())
        with open(src, "w") as fh:
            fh.write(text)
    lib = load_cuda_module(os.path.join(out, label),
                           f"split_cuda_{label.replace('+', '_')}").load()
    if stamps:
        lib.fn_split_read.argtypes = [ctypes.c_void_p]
        lib.fn_split_read.restype = ctypes.c_int
        lib.fn_split_reset.restype = ctypes.c_int
    return lib


def capture(name: str, seed: int, frames: int):
    """(scene, [(args, kwargs)], counter): the inputs of every fused_newton
    call in the first `frames` frames of the episode of `seed` on the cell
    `name`, cloned, and what lattice_kernels.cover_vertices counted."""
    cell = fbrun.resolve(ROOT, name)
    body = meshgen.body(cell.config["mesh"])
    geo = geometry.Geometry(body, cell.config["material"])
    dev = torch.device("cuda")
    system = cell.driver.System(body, geo, cell.config, cell.mix, dev)
    calls = []
    orig = lk.fused_newton

    def hook(*args, **kwargs):
        calls.append((tuple(a.clone() if torch.is_tensor(a) else a
                            for a in args), dict(kwargs)))
        return orig(*args, **kwargs)
    lk.fused_newton = hook
    lk.reset_launches()
    try:
        stream = traffic.requests(cell.mix, seed)
        for _ in range(frames):
            system.serve(next(stream))
    finally:
        lk.fused_newton = orig
    torch.cuda.synchronize()
    if not calls:
        raise RuntimeError(f"{name}: no fused_newton call")
    return system.scene, calls, dict(getattr(lk, "cover_vertices", {}))


def call_with(lib, args, kwargs):
    """fused_newton(*args, **kwargs) through the kernel library `lib`."""
    saved = _cuda._lib
    _cuda._lib = lib
    try:
        return lk.fused_newton(*args, **kwargs)
    finally:
        _cuda._lib = saved


def bits(out):
    """dx, f, fn, k of a call as tensors whose == is bit equality."""
    return [t.contiguous().view(torch.int32) for t in out]


def same(a, b):
    """(torch.equal on every output, bit-equal on every output)."""
    eq = all(torch.equal(x, y) for x, y in zip(a, b))
    exact = all(torch.equal(x, y) for x, y in zip(bits(a), bits(b)))
    return eq, exact


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", default="shell64.frames")
    ap.add_argument("--against", default=None,
                    help="another checkout, its library run beside this one")
    ap.add_argument("--seed", type=int, default=3230000001)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, ".scratch",
                                                  "fused_newton_split"))
    ap.add_argument("--json", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    trees = [("this", ROOT)]
    if a.against:
        trees.append(("against", os.path.abspath(a.against)))
    libs = {"this": _cuda.load()}
    with concurrent.futures.ThreadPoolExecutor(len(trees) * 2) as pool:
        jobs = {f"{label}+stamps": pool.submit(library_copy, tree, a.out,
                                               f"{label}+stamps", True)
                for label, tree in trees}
        if a.against:
            jobs["against"] = pool.submit(library_copy, trees[1][1], a.out,
                                          "against", False)
        for label, job in jobs.items():
            libs[label] = job.result()
    order = ["this"] + (["against"] if a.against else [])
    scene, calls, counted = capture(a.cell, a.seed, a.frames)
    X, Y, Z = scene.shape
    cover = calls[0][1].get("cover")
    plan = (lk._newton_plan(libs["this"], X, Y, Z, scene.x0.device)
            if cover is None else
            lk._cover_plan(cover, "newton", scene.x0.device))
    print(f"{a.cell}: {len(calls)} fused_newton calls "
          f"({'dense' if cover is None else 'covered'}) in {a.frames} "
          f"frames (seed {a.seed}), lattice {X}x{Y}x{Z} = {X * Y * Z} "
          f"vertices, body {int(scene.vert_mask.sum())}, plan {plan}; "
          f"cover_vertices {counted}")
    print(torch.cuda.get_device_name(), flush=True)

    for lib in libs.values():
        # lat_newton_plan allows each library's kernel the shared memory of
        # its largest plan, as the first dense call of a process does
        lk.ask_newton_plan(lib, X, Y, Z, scene.x0.device)
    ok = True
    ref = [[t.clone() for t in call_with(libs["this"], *c)] for c in calls]
    ks = [int(r[3]) for r in ref]
    times = {label: [[] for _ in calls] for label in order}
    exact = {label: [] for label in order}
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    for rep in range(a.reps):
        for i, c in enumerate(calls):
            for label in (order if rep % 2 == 0 else order[::-1]):
                start.record()
                out = call_with(libs[label], *c)
                end.record()
                end.synchronize()
                times[label][i].append(start.elapsed_time(end) * 1e3)
                if rep == 0:
                    eq, bit_eq = same(out, ref[i])
                    if not eq:
                        ok = False
                        print(f"call {i}: {label} differs from this tree's "
                              f"library", file=sys.stderr)
                    exact[label].append(bit_eq)
    result = {"cell": a.cell, "calls": len(calls), "k": ks,
              "cover_vertices": counted, "shape": [X, Y, Z],
              "body_vertices": int(scene.vert_mask.sum()), "plan": list(plan),
              "device": torch.cuda.get_device_name(), "libraries": {}}
    for label in order:
        per = [statistics.median(t) for t in times[label]]
        result["libraries"][label] = {
            "us_per_launch_median": statistics.median(per),
            "us_per_launch_mean": sum(per) / len(per),
            "us_total": sum(per),
            "us_per_call": per,
            "bit_equal_to_this": all(exact[label]),
        }
    for label, _ in trees:
        slib = libs[f"{label}+stamps"]
        _cuda.check(slib.fn_split_reset(), "fn_split_reset")
        for i, c in enumerate(calls):
            out = call_with(slib, *c)
            _, bit_eq = same(out, ref[i]) if label == "this" else same(
                out, call_with(libs[label], *c))
            if not bit_eq:
                ok = False
                print(f"call {i}: the stamps changed {label}'s bits",
                      file=sys.stderr)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (SPLIT_BLOCKS * 4))()
        _cuda.check(slib.fn_split_read(buf), "fn_split_read")
        rows = [buf[4 * b:4 * b + 4] for b in range(SPLIT_BLOCKS)
                if buf[4 * b + 3] > 0]
        n = rows[0][3]
        split = [sum(r[j] for r in rows) / len(rows) / n for j in range(3)]
        total = sum(split)
        lib_us = result["libraries"][label]["us_per_launch_mean"]
        result["libraries"][label]["split"] = {
            "blocks": len(rows), "launches": n,
            "cycles_per_launch": total,
            "shares": dict(zip(CATEGORIES, (s / total for s in split))),
            "us_per_launch_at_library_time": dict(
                zip(CATEGORIES, (lib_us * s / total for s in split))),
            "vector_phases_per_launch": sum(ks) / len(ks),
        }
    print(f"PCG count k a launch: mean {sum(ks) / len(ks):.2f} "
          f"(vector phases a launch: k; matvecs k - 1)")
    for label in order:
        r = result["libraries"][label]
        s = r["split"]
        us = s["us_per_launch_at_library_time"]
        print(f"{label:8s} device us a launch: median "
              f"{r['us_per_launch_median']:.1f}, mean "
              f"{r['us_per_launch_mean']:.1f}, total {r['us_total']:.1f} "
              f"over {len(calls)} calls; bit-equal to this: "
              f"{r['bit_equal_to_this']}")
        print(f"{'':8s} split of {s['cycles_per_launch']:.0f} cycles a "
              f"launch ({s['blocks']} blocks, {s['launches']} launches): "
              + ", ".join(f"{k} {100 * v:.1f}% ({us[k]:.1f} us)"
                          for k, v in s["shares"].items()))
        print(f"{'':8s} a vector phase: "
              f"{us['vector phases'] / s['vector_phases_per_launch']:.2f} us")
    if a.json:
        with open(a.json, "w") as fh:
            json.dump(result, fh, indent=1)
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
