"""fused_newton_roofline (%): lat_fused_newton's share of its roofline over
the first traced stretch: the sum over its launches of the least time each
could take (bounds.fused_newton_work on the body's real vertices and cells,
with the k - 1 HVPs of that launch's own PCG count) over the sum of their
device times in the profiler's trace. The PCG counts are read from the k
each fused_newton call returned, kept while the stretch runs and read
after it (no sync added). Launches are paired with the trace's
fused_newton_kernel<false> spans in order; a trace that lost its last
events counts the launches it kept. Moves frame_ms."""

from fembench import bounds, trace

HOOKS = (("fem_simulation_tpu_torch.ops.lattice_kernels", "fused_newton"),)
KERNEL = "fused_newton_kernel<false>"


def record(box, args, kwargs, out):
    box.append(out[3])          # the launch's PCG count k, on the device


def read(run):
    ks = run.store.get("fused_newton_roofline", [])
    durs = trace.spans(run.dev, KERNEL)
    n = min(len(ks), len(durs))
    if run.peak is None or n == 0:
        return None
    geo = run.geo
    least = sum(bounds.bound_s(*bounds.fused_newton_work(
        geo.n_verts, geo.n_cells, int(k)), run.peak) for k in ks[:n])
    run.note(f"fused_newton_roofline: {n} launches paired of {len(ks)} "
             f"calls and {len(durs)} traced, mean k "
             f"{sum(int(k) for k in ks[:n]) / n:.2f}, device "
             f"{sum(durs[:n]):.1f} us, bound {least * 1e6:.1f} us")
    return 100.0 * least / (sum(durs[:n]) * 1e-6)
