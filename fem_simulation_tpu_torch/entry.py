"""Entry points of the port: a one-device step and a multi-device dry run.

Port of the repo root's `__graft_entry__.py`:

    from fem_simulation_tpu_torch import entry
    fn, args = entry.entry()          # one lattice step_to_tol on the GPU
    state = fn(*args)
    entry.dryrun_multichip(4)         # six distributed programs on 4 slabs

The reference's dry run forces JAX onto n virtual CPU devices. Here the
slabs sit on a DeviceGrid: with no device given, the visible GPUs, the
slabs sharing a card where there are fewer cards than slabs; device="cpu"
runs the plain versions on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from . import mesh as meshlib
from .config import SolverConfig


def entry(device=None):
    """(fn, example_args): fn(None, state) -> state is one structured-lattice
    implicit-Euler frame to ||f||_inf <= 1e-4 (sim/lattice.step_to_tol, its
    Newton iterations through the fused Newton kernel on the GPU)."""
    from .sim import lattice as latmod

    scene = latmod.LatticeScene(meshlib.beam(4, 4, 8, dx=0.1), device=device)
    state = scene.init_state()

    def fn(_, st):
        st2, k, fn_inf = latmod.step_to_tol(scene, st, tol=1e-4)
        return st2

    return fn, (None, state)


def _tiny_scene(shape, n_levels=2, pad_to=1, device=None):
    from .sim import Scene
    return Scene(meshlib.beam(*shape, dx=0.1),
                 solver=SolverConfig(n_levels=n_levels), pad_to=pad_to,
                 device=device)


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run, on an n_devices grid, the six distributed programs whose lines
    the reference's dry run prints: the dp x sp batched step, the lattice
    halo force (here at a seeded displacement, where the reference takes
    the force at rest, zero on both sides), the distributed lattice step,
    the distributed multigrid step and quasi-static solve, and the
    distributed unstructured Newton step; print a line for each and return
    the lines. Raises on a non-finite result, a halo force off the whole
    lattice's by more than 1e-5 of its max, or a solve that misses its
    tolerance."""
    from .parallel import dist, halo, make_device_mesh
    from .parallel import lattice_halo as lh
    from .parallel import lattice_mg_dist as mgd
    from .ops import lattice_kernels as lk
    from .sim import lattice as latmod

    lines = []

    def say(text):
        print(text, flush=True)
        lines.append(text)

    grid = make_device_mesh(n_devices, device=device)
    dp = grid.shape["dp"]
    scene = _tiny_scene((2, 2, 4), pad_to=max(n_devices, 2),
                        device=grid.device)
    step_fn, params, state0 = dist.make_batched_step(scene, grid,
                                                     batch=max(dp, 2))
    x = dist.stack_batch(step_fn(params, state0)).x
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError("multichip step produced non-finite state")
    say(f"dryrun_multichip ok: mesh={grid.devices.shape} ('dp','sp'), "
        f"state {tuple(x.shape)}")

    line = make_device_mesh(n_devices, dp=1, device=device)
    lscene = latmod.LatticeScene(meshlib.beam(2, 2, 4 * n_devices + 1,
                                              dx=0.1), device=line.device)
    slabs = lh.LatticeSlabs(lscene, n_devices, line)
    force = lh.make_dist_force(slabs, line)
    # at a seeded displacement (the force at rest is zero on both sides)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(0.01 * rng.standard_normal(
        tuple(lscene.x0.shape)).astype(np.float32)).to(line.device)
    u = u * lscene.vert_mask[..., None]
    fb = slabs.gather(force(slabs.scatter(lscene.x0 + u)))
    ref = lk.force_cf(u.permute(3, 0, 1, 2).contiguous(), lscene.cell_mask,
                      0.1, 250.0, 0.0).permute(1, 2, 3, 0)
    err = float((fb - ref).abs().max())
    scale = float(ref.abs().max())
    if not (scale > 0 and err <= 1e-5 * scale):
        raise RuntimeError(f"lattice halo force mismatch: {err} of {scale}")
    say(f"dryrun lattice halo ok: {n_devices} z-slabs, err {err:.2e} "
        f"(max|f| {scale:.2e})")

    step, blockify = lh.make_dist_step(slabs, line)
    xb, vb, k, fn = step(blockify(lscene.x0),
                         blockify(torch.zeros_like(lscene.x0)))
    if not bool(torch.isfinite(slabs.gather(xb)).all()):
        raise RuntimeError("distributed lattice step non-finite")
    say(f"dryrun dist lattice step ok: newton={k}, fn={fn:.3e}")

    mg_step, place = mgd.make_dist_mg_step(lscene, line, n_levels=2)
    st, k, fn = mg_step(place(lscene.init_state()))
    st = mg_step.unplace(st)
    if not (bool(torch.isfinite(st.x).all()) and fn <= 1e-4):
        raise RuntimeError(f"distributed GMG step: fn {fn}")
    say(f"dryrun dist GMG step ok: newton={k}, fn={fn:.3e}")

    solve, place = mgd.make_dist_mg_quasistatic(lscene, line, n_levels=2)
    xq, k, fn = solve(place(lscene.x0))
    xq = solve.unplace(xq)
    if not (bool(torch.isfinite(xq).all()) and fn <= 1e-4):
        raise RuntimeError(f"distributed GMG quasistatic: fn {fn}")
    say(f"dryrun dist GMG quasistatic ok: newton={k}, fn={fn:.3e}")

    uscene = _tiny_scene((2, 2, 4 * n_devices), device=line.device)
    part = halo.partition_slabs(uscene.hier.levels[0], n_devices)
    nstep = halo.make_dist_newton_step(uscene, part, line, tol=1e-4)
    x_sh = halo.slab_scatter(part, uscene.x0, line.line("sp"))
    x2, v2, k, fn = nstep(x_sh, [torch.zeros_like(x) for x in x_sh])
    xg = halo.slab_gather(part, x2, uscene.hier.levels[0].n_verts)
    if not (np.isfinite(xg).all() and fn <= 1e-4 * 1.01):
        raise RuntimeError(f"distributed unstructured Newton: fn {fn}")
    say(f"dryrun dist unstructured Newton ok: newton={k}, fn={fn:.3e}")
    return lines
