"""Run one cell of the benchmark once.

    python3 -m fembench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; its configuration (`fembench/configs/<config>.json`), its
traffic mix (`fembench/mixes/<mix>.json`, read by traffic.py, whose
`driver` names `fembench/drivers/<driver>.py`), the limits of its check
(`fembench/limits/<cell>.json`) and its per-layer metrics
(`fembench/metrics/<metric>.py`) are found by those names.

A run: set-up (imports, the CUDA context, the program's library, the
scene and its hierarchy, the warm-up requests: `setup_s`, from the start
of the process), then requests back to back for `--seconds` (the window:
the cell's rate metric is the window's wall time over the requests it
completed, each ending in a synchronize), then with `--trace 1` two traced
stretches of the same stream (the device alone: busy time, kernel times
and the hooks the metrics ask for; host and device: the idle gaps), then
the check: a seeded sample of the window's answers and its hardest one
judged by the plain reference in float64, each number printed beside its
limit. The last line of standard output is the result, in JSON.

Fails, printing no result, without a CUDA device (or fewer than the cell
asks for), and when jax, jaxlib, flax or the JAX package
fem_simulation_tpu is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import random
import sys
import time
from types import SimpleNamespace

# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "fem_simulation_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux /proc; else since the
    harness was imported)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules():
    """The forbidden top-level names among the loaded modules."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(root: str, kind: str, name: str):
    """fembench/<kind>/<name>.py of the checkout at root, by its path."""
    path = os.path.join(root, "fembench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"fembench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(root: str, *parts):
    with open(os.path.join(root, *parts)) as fh:
        return json.load(fh)


def resolve(root: str, workload: str) -> SimpleNamespace:
    """A workload of BENCHMARK.json with everything it names."""
    from . import traffic
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root, cfg_entry["file"])
    mix = traffic.load(root, w["traffic"])

    def here(m):
        return m.get("workloads") is None or workload in m["workloads"]
    return SimpleNamespace(
        name=workload, entry=w, config=config, mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if here(m)],
        per_layer=[m for m in bench["per_layer"] if here(m)],
        limits=load_json(root, "fembench", "limits", workload + ".json"),
        driver=load_module(root, "drivers", mix["driver"]))


class Sampler:
    """A uniform sample of `size` answers of the window (a reservoir drawn
    from the seed) and the answer of the request with the most Newton
    iterations."""

    def __init__(self, size: int, seed: int):
        from . import traffic
        self.size, self.seen, self.kept = size, 0, []
        self.rng = random.Random(traffic.derive(seed, 0, stream=1))
        self.hardest = None

    def offer(self, answer, k: int):
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(answer)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.kept[j] = answer
        if self.hardest is None or k > self.hardest[0]:
            self.hardest = (k, answer)

    def answers(self):
        out = list(self.kept)
        if self.hardest is not None and not any(
                a is self.hardest[1] for a in out):
            out.append(self.hardest[1])
        return out


@contextlib.contextmanager
def hooked(metrics, store):
    """While open, every (module, attribute) a metric module lists in HOOKS
    calls the metric's record(store[name], args, kwargs, out) after it
    returns; the call itself goes on unchanged."""
    saved = []
    try:
        for name, mod in metrics:
            for modname, attr in getattr(mod, "HOOKS", ()):
                target = importlib.import_module(modname)
                orig = getattr(target, attr)
                saved.append((target, attr, orig))
                store.setdefault(name, [])

                def wrapper(*args, _orig=orig, _rec=mod.record,
                            _box=store[name], **kwargs):
                    out = _orig(*args, **kwargs)
                    _rec(_box, args, kwargs, out)
                    return out
                setattr(target, attr, wrapper)
        yield
    finally:
        for target, attr, orig in reversed(saved):
            setattr(target, attr, orig)


def serve_for(system, stream, sync, until=None, count=None, on_answer=None):
    """Requests back to back until `until` seconds have passed or `count`
    have completed, each ending in sync(). Returns ([(k, fn, ms)], wall s)."""
    recs = []
    t0 = time.perf_counter()
    while True:
        req = next(stream)
        a = time.perf_counter()
        k, fn, ans = system.serve(req)
        sync()
        b = time.perf_counter()
        recs.append((k, fn, (b - a) * 1e3))
        if on_answer is not None:
            on_answer(ans, k)
        if (until is not None and b - t0 >= until) or (
                count is not None and len(recs) >= count):
            return recs, b - t0


def per_second(recs):
    """The requests completed in each whole second of the window."""
    out, t, n = [], 0.0, 0
    for _, _, ms in recs:
        t += ms * 1e-3
        while t >= len(out) + 1.0:
            out.append(n)
            n = 0
        n += 1
    return out


def library_builds() -> dict:
    """Seconds the program spent building its libraries in this process
    (nvcc for the CUDA kernels, g++ for the host library; 0 where a
    checkout's earlier run left them built), as the program records them."""
    return {key: getattr(sys.modules.get(name), "build_seconds", 0.0)
            for key, name in (("cuda", "fem_simulation_tpu_torch.ops._cuda"),
                              ("native", "fem_simulation_tpu_torch.native"))}


def build_system(cell, body, geo, dev, sync, system_hook=None):
    """The cell's program built and warmed up: its driver's System, every
    shape the mix uses (the driver's warm(), then the mix's warm_requests
    from a stream of their own, their answers kept as the window keeps
    them, so that the allocator holds what the window will), then the
    garbage collector's objects frozen, so that its full collections in the
    window do not scan what set-up made."""
    import gc

    from . import traffic
    system = cell.driver.System(body, geo, cell.config, cell.mix, dev)
    if system_hook is not None:
        system_hook(system)
    system.warm()
    keep = Sampler(int(cell.mix["sample"]), traffic.WARM_SEED)
    serve_for(system, traffic.requests(cell.mix, traffic.WARM_SEED), sync,
              count=int(cell.mix["warm_requests"]), on_answer=keep.offer)
    del keep
    sync()
    gc.collect()
    gc.freeze()
    return system


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", log=None, system_hook=None):
    """One run of a cell; returns the result dict. `device` 'cpu' (the
    tests) runs the program's plain versions and reads no device metric.
    system_hook(system), when given, is called on the built system before
    the warm-up (the tests plant faults with it)."""
    import torch

    from . import geometry, meshgen, traffic
    from . import trace as tr
    from .reference import Model

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    torch.set_num_threads(1)
    cell = resolve(root, workload)
    cfg, mix = cell.config, cell.mix
    cuda = device != "cpu"
    dev = torch.device("cuda:0" if cuda else "cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # -- set-up ---------------------------------------------------------
    body = meshgen.body(cfg["mesh"])
    geo = geometry.Geometry(body, cfg["material"])
    system = build_system(cell, body, geo, dev, sync, system_hook)
    setup_s = process_age()
    builds = library_builds()
    log(f"fembench {workload}: set-up {setup_s:.3f} s, {geo.n_verts} "
        f"vertices, {geo.n_cells} cells, lattice {geo.shape}; of it the "
        f"libraries' builds in this process {builds}")

    # -- the window -------------------------------------------------------
    sampler = Sampler(int(mix["sample"]), seed)
    stream = traffic.requests(mix, seed)
    recs, window_s = serve_for(system, stream, sync, until=seconds,
                               on_answer=sampler.offer)
    tol = float(mix["tol"])
    failed = sum(1 for _, fn, _ in recs if not fn <= tol)
    log(f"fembench {workload}: {len(recs)} requests in {window_s:.3f} s, "
        f"{failed} above tol {tol:g}; a second of the window at a time: "
        f"{per_second(recs)}")

    run = SimpleNamespace(requests=recs, window_s=window_s, geo=geo, dev=[],
                          busy_s=0.0, stretch_s=0.0, store={},
                          device_name=(torch.cuda.get_device_name(dev)
                                       if cuda else "cpu"),
                          note=log)
    from . import bounds
    run.peak = bounds.peaks(run.device_name)
    breakdown, metrics = None, []
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        metrics = [(m["name"], load_module(root, "metrics", m["name"]))
                   for m in cell.per_layer]
        with profile(activities=acts):      # the profiler's own start-up
            serve_for(system, stream, sync, count=1)
        with profile(activities=acts) as prof:
            with hooked(metrics, run.store):
                _, run.stretch_s = serve_for(
                    system, stream, sync, count=int(mix["trace_requests"]))
        run.dev, _ = tr.events(prof) if cuda else ([], [])
        run.busy_s = tr.busy_us(run.dev) * 1e-6
        acts_b = acts + ([ProfilerActivity.CPU] if cuda else [])
        with profile(activities=acts_b) as prof_b:
            with torch.profiler.record_function("fembench.stretch"):
                serve_for(system, stream, sync,
                          count=int(mix["trace_gap_requests"]))
        dev_b, host_b = tr.events(prof_b)
        span = [h for h in host_b if h[0] == "fembench.stretch"]
        inner = [h for h in host_b if h[0] != "fembench.stretch"]
        gaps = (tr.idle_gaps(dev_b, inner, span[0][1], span[0][2])
                if span and cuda else [])
        breakdown = {"device_ops": tr.top_ops(run.dev), "idle_gaps": gaps}
        log(f"fembench {workload}: traced {mix['trace_requests']} requests "
            f"in {run.stretch_s:.3f} s, device busy {run.busy_s:.6f} s, "
            f"{len(run.dev)} device events")

    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # -- per-layer metrics, then the program's state freed --------------
    values = {}
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    for name, mod in metrics:
        v = mod.read(run)
        if v is not None:
            values[name] = {"value": float(v), "unit": units[name]}
    answers = sampler.answers()
    del system, run.store
    if cuda:
        torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    t_check = time.perf_counter()
    model = Model(geo, cfg["material"], dev, dtype=torch.float64)
    readings = [cell.driver.judge(model, a, cfg, mix) for a in answers]
    worst = max(readings) if readings else float("inf")
    checks = {"resid_max": {"value": worst,
                            "limit": cell.limits["resid_max"]["limit"]}}
    correct = bool(readings) and bool(worst <= checks["resid_max"]["limit"])
    log(f"fembench {workload}: judged {len(readings)} answers in "
        f"{time.perf_counter() - t_check:.3f} s")

    if not trace:
        rate = cell.mix["rate_metric"]
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                values["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == rate:
                values[rate] = {"value": window_s * 1e3 / len(recs),
                                "unit": m["unit"]}
    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": run.device_name, "count": 1,
               "memory_peak_bytes": int(memory_peak)}
    if trace:
        devinfo.update(busy_s=run.busy_s, window_s=run.stretch_s)
    result = {"correct": bool(correct), "attempted": len(recs),
              "failed": failed, "metrics": values, "device": devinfo}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # the set-up's library builds apart: 0 but in a checkout's first run
    result["build_s"] = builds
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"fembench: forbidden modules loaded: {found}")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    import torch
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    chips = int(cells[args.workload]["chips"]) if args.workload in cells else 1
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"fembench: needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
