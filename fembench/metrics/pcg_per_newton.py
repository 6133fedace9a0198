"""pcg_per_newton (matvec/newton): the PCG matvecs of lat_fused_newton a
Newton iteration over the first traced stretch: the program's device
counter ops/lattice_kernels.py:pcg (each fused_newton call's PCG count k
summed on the card, no sync; a matvec is k less one a call) over
sim/lattice.py's lattice.counts["newton"], both taken as each frame ends
(the hook on solvers/cg.py:newton_exit_norm, which step_to_tol calls once a
frame: the counter's tensors kept by reference, read after the stretch) and
differenced between the stretch's first frame and its last, so whole frames
only. None without a CUDA device or where the program keeps no such
counters. Moves frame_ms: each matvec is a pass of the fused Newton
kernel's PCG over the lattice (or the low-fill cover)."""

import sys

HOOKS = (("fem_simulation_tpu_torch.solvers.cg", "newton_exit_norm"),)
LATTICE = "fem_simulation_tpu_torch.sim.lattice"
KERNELS = "fem_simulation_tpu_torch.ops.lattice_kernels"


def record(box, args, kwargs, out):
    counts = getattr(sys.modules.get(LATTICE), "counts", None)
    pcg = getattr(sys.modules.get(KERNELS), "pcg", None)
    if counts is not None and pcg is not None:
        box.append((counts["newton"], dict(pcg)))


def read(run):
    ends = run.store.get("pcg_per_newton", [])
    if not run.dev or len(ends) < 2:
        return None
    (newton0, pcg0), (newton1, pcg1) = ends[0], ends[-1]
    newton = newton1 - newton0
    if newton <= 0:
        return None
    matvecs = 0
    for dev, (total1, calls1) in pcg1.items():
        total0, calls0 = pcg0.get(dev, (None, 0))
        k = int(total1.item()) - (0 if total0 is None else int(total0.item()))
        matvecs += k - (calls1 - calls0)
    run.note(f"pcg_per_newton: {matvecs} matvecs in {newton} Newton "
             f"iterations")
    return matvecs / newton
