"""Block-ELL kernels: the public wrappers, their plain torch versions, counts.

`spmv` / `spmv_rows` port `fem_simulation_tpu/ops/pallas_kernels.py`
(`spmv`, the lanes-layout Pallas kernel) in the (N, K, 3, 3) ELL layout of
`ops/ell.py`, which a GPU can gather from directly: `ell_spmv` in
`csrc/ell_kernels.cu`, a group of `lanes(K)` lanes a row (the smallest
power of two >= K: 8 for the cloth's K = 7, 32 for a hex mesh's 27), lane
k slot k. `gs` and `jacobi` are the smoothers of
`solvers/smoothers.py` fused around the same row pass (`ell_gs`,
`ell_jacobi`): row product, 3x3 adjugate solve and update in one kernel,
all iterations in one call. `ell_gs` runs a call in the form its plan
picks (`ell_gs_plan` in C, mirrored by `gs_plan`; plans cached per shape in
`_gs_plans`): a cluster of up to 16 blocks holding the level's rows and x
in shared memory, a cooperative launch whose blocks keep their rows in
shared memory or stream them a pass ahead, or the first form, a warp a
row.

Gradients: `spmv` / `spmv_rows` and `jacobi` go through the autograd
Functions `EllSpmvFn` and `EllJacobiFn` whenever autograd records and an
input requires grad. Their backward runs three kernels of its own:
`spmv_t` (`ell_spmv_t`, the transposed product, a gather through a
transpose table built once on the host, `transpose_table`, in the form
and at the lanes its C entry picks, mirrored by `spmv_t_plan`;
`SPMV_T_FORMS`), `outer`
(`ell_outer`, the SpMV's gradient with respect to the values, in the
SpMV's lane groups) and `jacobi_bwd` (`ell_jacobi_bwd`, the adjoint of one
Jacobi iteration). A Jacobi iteration's adjoint is one `jacobi_bwd` launch
(lam, b's gradient and the whole values' gradient row: the diagonal
blocks' derivative and -lam (x) x_t in the other slots; from the zero start
it reads no x_t) and, where the iterate before it needs a gradient,
`spmv_t` without the diagonal slot; the forward keeps every iterate (one
launch an iteration into its own output). `gs` has no backward and raises
when asked for one.

`ell_jacobi` gives a row a group of `jacobi_lanes(N, sms)` lanes (the most
of 32, 16 and 8 whose grid fits one wave) and runs an iteration in one of
two forms (`JACOBI_FORMS`): the first iteration from x0 = None in the
zero-start form, which reads no nbr or mask and gathers no x (but still
forms every slot's product with the zero x, so a non-finite value
propagates), every other in the form that gathers x; with or without
autograd. `ell_jacobi_bwd` takes the same row
groups (8 lanes without the values' gradient) and writes a block's rows'
values gradient, one contiguous span, with 16-byte stores.

Dispatch: a wrapper checks its arguments' dtypes, shapes and contiguity,
then runs its plain version (`*_plain`) only when its tensors lie on the
CPU. For CUDA tensors it launches the kernel or raises; it never falls back.
`launches[name]` counts kernel launches (`spmv`: one per call with a
non-empty row range; `gs`: one per call with iterations > 0, taken apart by
(rows, form) in `gs_launches`; `jacobi`: one per iteration, taken apart by
(rows, form) in `jacobi_launches`; `spmv_t`: one per call, taken apart by
(rows, form) in `spmv_t_launches`; `outer`, `jacobi_bwd`: one per call);
`ops.ell.cuda_calls` counts, one
layer up (for the backward kernels: in the Functions' backward), the
launches that the calls made on CUDA tensors ask for, so a run can check
that every call launched.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _cuda

launches = {"spmv": 0, "gs": 0, "jacobi": 0, "spmv_t": 0, "outer": 0,
            "jacobi_bwd": 0}
# ell_gs's launches by (rows, form name): launches["gs"] taken apart
gs_launches: dict = {}
# ell_jacobi's launches by (rows, form name): launches["jacobi"] taken apart
jacobi_launches: dict = {}
# ell_spmv_t's launches by (rows, form name): launches["spmv_t"] taken apart
spmv_t_launches: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    gs_launches.clear()
    jacobi_launches.clear()
    spmv_t_launches.clear()


def lanes(k: int) -> int:
    """The lanes a row of ell_spmv / ell_outer at ELL width k, as their C
    entries pick it: the smallest power of two >= k."""
    return 1 << max(int(k) - 1, 0).bit_length()


def spmv_rows_plain(values, nbr, mask, x, r0: int, r1: int):
    """y[r0:r1] of A @ x: gather, multiply by the mask, contract."""
    xg = x[nbr[r0:r1]] * mask[r0:r1, :, None]            # (R, K, 3)
    return torch.einsum("nkji,nki->nj", values[r0:r1], xg)


def spmv_plain(values, nbr, mask, x):
    return spmv_rows_plain(values, nbr, mask, x, 0, values.shape[0])


def _check(values, nbr, mask, x):
    if values.dim() != 4 or tuple(values.shape[2:]) != (3, 3):
        raise ValueError(f"values: expected (N, K, 3, 3), got {tuple(values.shape)}")
    n, k = int(values.shape[0]), int(values.shape[1])
    if k > 32:
        raise ValueError(f"ELL width {k} > 32: the kernel takes one lane per slot")
    _cuda.require(values, (n, k, 3, 3), "values")
    _cuda.require(nbr, (n, k), "nbr", dtype=torch.int32)
    _cuda.require(mask, (n, k), "mask")
    _cuda.require(x, (n, 3), "x")
    return n, k


def _count_call(name: str, t) -> None:
    """ops.ell.cuda_calls[name] += 1 for a launch asked for on CUDA tensors."""
    if t.is_cuda:
        from . import ell
        ell.cuda_calls[name] += 1


def _spmv_rows(values, nbr, mask, x, r0: int, r1: int):
    """The forward, arguments checked: plain on the CPU, else one launch."""
    if _cuda.on_cpu(values, nbr, mask, x):
        return spmv_rows_plain(values, nbr, mask, x, r0, r1)
    y = torch.empty((r1 - r0, 3), dtype=torch.float32, device=x.device)
    if r1 == r0:
        return y
    lib = _cuda.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ell_spmv(values.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                           x.data_ptr(), y.data_ptr(), r0, r1,
                           int(values.shape[1]), stream)
    launches["spmv"] += 1
    _cuda.check(err, "ell_spmv")
    return y


class EllSpmvFn(torch.autograd.Function):
    """y = (A @ x)[r0:r1], differentiable in values and x. Backward: the
    values' gradient g (x) (x[nbr] mask) by `outer`, x's A^T g by `spmv_t`
    (rows outside [r0, r1) take a zero gradient). tt: A's transpose table
    (`transpose_table(nbr)`), or None when x takes no gradient."""

    @staticmethod
    def forward(ctx, values, x, nbr, mask, r0, r1, tt):
        if ctx.needs_input_grad[1] and tt is None:
            raise ValueError("x's gradient needs A's transpose table tt")
        ctx.save_for_backward(values, x, nbr, mask, tt)
        ctx.rows = (r0, r1)
        return _spmv_rows(values, nbr, mask, x, r0, r1)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        values, x, nbr, mask, tt = ctx.saved_tensors
        r0, r1 = ctx.rows
        n = values.shape[0]
        g = gy.contiguous()
        if (r0, r1) != (0, n):
            g = torch.zeros((n, 3), dtype=gy.dtype, device=gy.device)
            g[r0:r1] = gy
        gv = gx = None
        cpu = not g.is_cuda        # any float dtype there (gradcheck)
        if ctx.needs_input_grad[0]:
            _count_call("outer", g)
            gv = (outer_plain if cpu else outer)(g, nbr, mask, x)
        if ctx.needs_input_grad[1]:
            _count_call("spmv_t", g)
            gx = (spmv_t_plain if cpu else spmv_t)(values, mask, tt, g)
        return gv, gx, None, None, None, None, None


def spmv_rows(values, nbr, mask, x, r0: int, r1: int):
    """y = (A @ x)[r0:r1], (r1 - r0, 3), for A in block-ELL form.
    Differentiable in values and x (`EllSpmvFn`; when x requires grad, A's
    transpose table is built here from nbr, one host copy a call)."""
    n = _check(values, nbr, mask, x)[0]
    r0, r1 = int(r0), int(r1)
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"row range [{r0}, {r1}) outside [0, {n})")
    if _cuda.records_grad(values, x, mask):
        _cuda.refuse_grad("mask, a 0/1 table,", mask)
        tt = transpose_table(nbr) if _cuda.records_grad(x) else None
        return EllSpmvFn.apply(values, x, nbr, mask, r0, r1, tt)
    return _spmv_rows(values, nbr, mask, x, r0, r1)


def spmv(values, nbr, mask, x):
    """y = A @ x, (N, 3), for A in block-ELL form: values (N, K, 3, 3),
    nbr (N, K) int32, mask (N, K) 0/1 float32, x (N, 3)."""
    return spmv_rows(values, nbr, mask, x, 0, values.shape[0])


# -- the backward kernels ------------------------------------------------------

def transpose_table(nbr) -> torch.Tensor:
    """(N, Kt) int32 on nbr's device: row j lists the flat entries
    e = i * K + k with nbr[i, k] == j in increasing e, padded with -1; Kt is
    the largest count (K for the repo's structurally symmetric operators,
    whose padded slots point at their own row). Built on the host."""
    nb = nbr.detach().cpu().numpy().astype(np.int64).reshape(-1)
    n = int(nbr.shape[0])
    order = np.argsort(nb, kind="stable")
    cols = nb[order]
    pos = np.arange(nb.size) - np.searchsorted(cols, cols)
    kt = int(pos.max()) + 1 if nb.size else 1
    table = np.full((n, kt), -1, dtype=np.int32)
    table[cols, pos] = order.astype(np.int32)
    return torch.from_numpy(table).to(nbr.device)


def spmv_t_plain(values, mask, tt, g, skip=None, alpha: float = 1.0):
    """The kernel's plain version: per entry mask values^T g[row], gathered
    through the transpose table and summed over its row."""
    n, k = mask.shape
    part = torch.einsum("nkji,nj->nki", values, g) * mask[..., None]
    if skip is not None:
        slots = torch.arange(k, device=values.device)
        keep = slots[None, :] != skip.long()[:, None]
        part = torch.where(keep[..., None], part, torch.zeros_like(part))
    src = torch.cat([part.reshape(-1, 3), part.new_zeros((1, 3))])
    idx = torch.where(tt >= 0, tt.long(), torch.full_like(tt.long(), n * k))
    return alpha * src[idx].sum(dim=1)


def outer_plain(g, nbr, mask, x, skip=None, alpha: float = 1.0, out=None,
                accumulate: bool = False):
    """The kernel's plain version, into `out` (allocated when None):
    slot k of row i (+)= alpha * g[i] (x) (x[nbr[i, k]] mask[i, k]); slot
    skip[i] untouched (zero in a new `out`)."""
    n, k = mask.shape
    xm = x[nbr.long()] * mask[..., None]
    p = alpha * (g[:, None, :, None] * xm[:, :, None, :])
    if out is None:
        out = torch.zeros((n, k, 3, 3), dtype=g.dtype, device=g.device)
    if accumulate:
        p = out + p
    if skip is not None:
        slots = torch.arange(k, device=g.device)
        keep = slots[None, :] != skip.long()[:, None]
        p = torch.where(keep[..., None, None], p, out)
    out.copy_(p)
    return out


def jacobi_bwd_plain(values, nbr, mask, diag_slot, b, xt, gbar, gb=None,
                     gv=None, accumulate: bool = False):
    """The kernel's plain version: returns lam = D^{-T} gbar by the
    forward's adjugate formula; gb (+)= lam, and the diagonal slots of gv
    (+)= the exact derivative of that formula in the diagonal blocks
    (csrc/ell_kernels.cu, ell_jacobi_bwd_kernel, has the algebra), then
    the other slots (+)= -lam (x) (xt[nbr] mask) as `outer_plain` forms
    it. xt None: the zero start (the residual is b; accumulating, the other
    slots are left as they are, since they would take -lam (x) 0)."""
    n = values.shape[0]
    rows = torch.arange(n, device=values.device)
    ds = diag_slot.long()
    D = values[rows, ds]
    # row p of the cofactor matrix: D_{p+1} x D_{p+2}
    C = torch.stack([torch.linalg.cross(D[:, (p + 1) % 3], D[:, (p + 2) % 3])
                     for p in range(3)], dim=1)
    det = (D[:, 0, 0] * C[:, 0, 0] + D[:, 0, 1] * C[:, 0, 1]
           + D[:, 0, 2] * C[:, 0, 2])
    den = det * det + 1e-12
    inv_det = det / den
    u = torch.einsum("npm,nm->np", C, gbar)
    lam = u * inv_det[:, None]
    if gb is not None:
        gb.copy_(gb + lam if accumulate else lam)
    if gv is not None:
        r = b if xt is None else b - _offdiag_rows_plain(
            values, nbr, mask, diag_slot, xt, 0, n)
        h = (1e-12 - det * det) / den / den * (r * u).sum(-1)
        gD = torch.stack([
            inv_det[:, None] * (
                r[:, (p + 2) % 3, None]
                * torch.linalg.cross(D[:, (p + 1) % 3], gbar)
                + r[:, (p + 1) % 3, None]
                * torch.linalg.cross(gbar, D[:, (p + 2) % 3]))
            + h[:, None] * C[:, p] for p in range(3)], dim=1)
        gv[rows, ds] = gv[rows, ds] + gD if accumulate else gD
    if gv is not None and (xt is not None or not accumulate):
        outer_plain(lam, nbr, mask, torch.zeros_like(b) if xt is None else xt,
                    skip=diag_slot, alpha=-1.0, out=gv, accumulate=accumulate)
    return lam


# ell_spmv_t's forms (csrc/ell_kernels.cu, kSpmvT*): a group of lanes a
# column, each lane one or two whole entries, reading its entries' values
# itself ("lanes") or from spans the group staged in shared memory
# ("staged"); the first form, a warp a column, lane t the entries t,
# t + 32, ... ("strided", any Kt)
SPMV_T_FORMS = ("lanes", "staged", "strided")
SPMV_T_LANES, SPMV_T_STAGED, SPMV_T_STRIDED = range(3)


def spmv_t_plan(n: int, kt: int, sms: int):
    """(form, lanes a column) of ell_spmv_t at n columns of kt entries on a
    card of `sms` SMs, as its C entry picks them (spmv_t_plan; from
    `scripts/spmv_t_forms.py` on an H100): kt > 32 the strided form at 32
    lanes; p = lanes(kt) = 32 (the hex meshes' 27) the staged form, on
    p / 2 lanes where the grid on p lanes would hold a block an SM;
    narrower tables (the cloth's 7 on 8) the lanes form, on p / 2 lanes
    where the grid on p lanes would hold two blocks an SM."""
    if kt > 32:
        return SPMV_T_STRIDED, 32
    p = lanes(kt)
    blocks = -(-n * p // 256)
    if p == 32:
        return SPMV_T_STAGED, p // 2 if blocks >= sms else p
    return SPMV_T_LANES, p // 2 if p >= 2 and blocks >= 2 * sms else p


def spmv_t(values, mask, tt, g, skip=None, alpha: float = 1.0):
    """gx (N, 3) = alpha * A^T g through A's transpose table tt (N, Kt)
    int32 (`transpose_table`); skip (N,) int32 or None: the slot of each
    row to leave out. One launch, in the form and at the lanes its C entry
    picks, counted by (rows, form) as the mirror `spmv_t_plan` names it."""
    if values.dim() != 4 or tuple(values.shape[2:]) != (3, 3):
        raise ValueError(f"values: expected (N, K, 3, 3), got {tuple(values.shape)}")
    n, k = int(values.shape[0]), int(values.shape[1])
    _cuda.require(values, (n, k, 3, 3), "values")
    _cuda.require(mask, (n, k), "mask")
    _cuda.require(g, (n, 3), "g")
    if tt.dim() != 2 or tt.shape[0] != n or tt.shape[1] < 1:
        raise ValueError(f"tt: expected ({n}, Kt), got {tuple(tt.shape)}")
    _cuda.require(tt, tuple(tt.shape), "tt", dtype=torch.int32)
    if skip is not None:
        _cuda.require(skip, (n,), "skip", dtype=torch.int32)
    tensors = (values, mask, tt, g) + (() if skip is None else (skip,))
    if _cuda.on_cpu(*tensors):
        return spmv_t_plain(values, mask, tt, g, skip, alpha)
    kt = int(tt.shape[1])
    gx = torch.empty((n, 3), dtype=torch.float32, device=g.device)
    lib = _cuda.load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = lib.ell_spmv_t(values.data_ptr(), mask.data_ptr(),
                             tt.data_ptr(),
                             None if skip is None else skip.data_ptr(),
                             g.data_ptr(), gx.data_ptr(), float(alpha), n, k,
                             kt, stream)
    launches["spmv_t"] += 1
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    key = (n, SPMV_T_FORMS[spmv_t_plan(n, kt, sms)[0]])
    spmv_t_launches[key] = spmv_t_launches.get(key, 0) + 1
    _cuda.check(err, "ell_spmv_t")
    return gx


def outer(g, nbr, mask, x, skip=None, alpha: float = 1.0, out=None,
          accumulate: bool = False):
    """gv (N, K, 3, 3): slot k of row i (+)= alpha * g[i] (x)
    (x[nbr[i, k]] mask[i, k]), into `out` (allocated when None; zeros
    where skip leaves a slot); skip (N,) int32 or None: the slot of each row
    left untouched; accumulate: add to `out` instead of storing."""
    n, k = mask.shape
    _cuda.require(g, (n, 3), "g")
    _cuda.require(nbr, (n, k), "nbr", dtype=torch.int32)
    _cuda.require(mask, (n, k), "mask")
    _cuda.require(x, (n, 3), "x")
    if skip is not None:
        _cuda.require(skip, (n,), "skip", dtype=torch.int32)
    if out is not None:
        _cuda.require(out, (n, k, 3, 3), "out")
    elif accumulate:
        raise ValueError("accumulate needs an out tensor")
    tensors = (g, nbr, mask, x) + tuple(t for t in (skip, out)
                                        if t is not None)
    if _cuda.on_cpu(*tensors):
        return outer_plain(g, nbr, mask, x, skip, alpha, out, accumulate)
    if out is None:
        out = (torch.empty if skip is None else torch.zeros)(
            (n, k, 3, 3), dtype=torch.float32, device=g.device)
    lib = _cuda.load()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = lib.ell_outer(g.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                            x.data_ptr(),
                            None if skip is None else skip.data_ptr(),
                            float(alpha), int(accumulate), out.data_ptr(), n,
                            k, stream)
    launches["outer"] += 1
    _cuda.check(err, "ell_outer")
    return out


def jacobi_bwd(values, nbr, mask, diag_slot, b, xt, gbar, gb=None, gv=None,
               accumulate: bool = False):
    """The adjoint of one Jacobi iteration that read xt (None: the zero
    start), in one launch: returns lam = D^{-T} gbar (N, 3); gb (N, 3) or
    None (+)= lam; gv (N, K, 3, 3) or None: its diagonal slots (+)= the
    diagonal blocks' gradient and the others (+)= -lam (x) (xt[nbr] mask)
    (accumulate: add, else store; from the zero start an accumulating call
    leaves the others as they are)."""
    n, k = _check_smoother(values, nbr, mask, diag_slot, b, xt)
    _cuda.require(gbar, (n, 3), "gbar")
    if gb is not None:
        _cuda.require(gb, (n, 3), "gb")
    if gv is not None:
        _cuda.require(gv, (n, k, 3, 3), "gv")
    tensors = (values, nbr, mask, diag_slot, b, gbar) + tuple(
        t for t in (xt, gb, gv) if t is not None)
    if _cuda.on_cpu(*tensors):
        return jacobi_bwd_plain(values, nbr, mask, diag_slot, b, xt, gbar,
                                gb, gv, accumulate)
    lam = torch.empty_like(gbar)
    lib = _cuda.load()
    stream = torch.cuda.current_stream(b.device).cuda_stream
    with torch.cuda.device(b.device):
        err = lib.ell_jacobi_bwd(
            values.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
            diag_slot.data_ptr(), b.data_ptr(),
            None if xt is None else xt.data_ptr(),
            gbar.data_ptr(), lam.data_ptr(),
            None if gb is None else gb.data_ptr(),
            None if gv is None else gv.data_ptr(), int(accumulate), n, k,
            stream)
    launches["jacobi_bwd"] += 1
    _cuda.check(err, "ell_jacobi_bwd")
    return lam


# -- fused smoothers -----------------------------------------------------------

# ell_gs's forms (csrc/ell_kernels.cu: kGsCoop ... kGsStream) and launch
# shapes (kRowsPerBlock rows a coop block; kGsThreads threads, kGsLanes
# lanes a row and kGsSmemCap bytes of dynamic shared memory a staged
# block; kMaxCluster blocks a cluster)
GS_FORMS = ("coop", "cluster", "resident", "stream")
GS_COOP, GS_CLUSTER, GS_RESIDENT, GS_STREAM = range(4)
GS_ROWS_PER_BLOCK = 8
GS_GROUPS = 512 // 8
GS_SMEM_CAP = 230400
GS_MAX_CLUSTER = 16
# ell_gs_plan's cost model (kGsModel), device us of an H100 per form:
# (launch, a KB staged by a block, a pass, a block a pass, a round of a
# block's row groups a pass, a KB a block reads a pass); fitted by
# scripts/ell_tilings.py --fit to its --sweep of every form at the main
# paths' levels
GS_MODEL = (
    (0.02696, 0.0, 0.2699, 0.00539, 0.0, 0.166),      # coop
    (8.294, 0.02867, 0.3159, 0.01804, 0.7804, 0.0),   # cluster
    (5.272, 0.02945, 1.553, 0.001241, 0.762, 0.0),    # resident
    (3.806, 0.0, 1.491, 0.007088, 0.0, 0.03735),      # stream
)
# ell_gs_plan's picks, computed once per (device, N, K, color offsets,
# iterations); a test or a measurement puts another (form, blocks) under
# that key to run it
_gs_plans: dict = {}


def gs_passes(color_offsets, iterations: int):
    """The colors of ell_gs's passes, in order: per iteration the non-empty
    colors last to first, then first to last, a color never twice in a row
    (the repeated pass would compute what the pass before it wrote)."""
    offs = [int(c) for c in color_offsets]
    seq = [c for c in range(len(offs) - 1) if offs[c + 1] > offs[c]]
    m = len(seq)
    if iterations < 1 or m == 0:
        return []
    if m == 1:
        return [seq[0]]
    period = 2 * m - 2
    return [seq[abs(m - 1 - p % period)]
            for p in range(iterations * period + 1)]


def gs_slice_starts(color_offsets, blocks: int) -> np.ndarray:
    """(colors, blocks + 1) int64: row c, r the first row of block r's slice
    of color c among `blocks` blocks (slice_start in csrc/ell_kernels.cu),
    its last entry the color's end."""
    offs = np.asarray(color_offsets, dtype=np.int64)
    size = (offs[1:] - offs[:-1])[:, None]
    return offs[:-1, None] + size * np.arange(
        blocks + 1, dtype=np.int64)[None, :] // blocks


def gs_slice_rows(color_offsets, blocks: int) -> np.ndarray:
    """(colors, blocks) int64: the rows of block r's slice of color c."""
    return np.diff(gs_slice_starts(color_offsets, blocks), axis=1)


def gs_layout_rows(color_offsets, form: int, blocks: int) -> int:
    """The rows of a staged form's shared layout (gs_layout_rows): the most
    rows a block owns, or for the stream form the widest slice."""
    rows = gs_slice_rows(color_offsets, blocks)
    return int(rows.max() if form == GS_STREAM else rows.sum(axis=0).max())


def gs_smem_bytes(form: int, n: int, k: int, rows: int) -> int:
    """Dynamic shared memory of a staged form's block (gs_smem_bytes): rows'
    values, mask, b, nbr, diag_slot and diagonal adjugate (two buffers of
    them for the stream form), and the cluster form's copy of x."""
    tables = (11 * k + 14) * rows
    return {GS_CLUSTER: 4 * (4 * n + tables), GS_RESIDENT: 4 * tables,
            GS_STREAM: 8 * tables}.get(form, 0)


def gs_features(color_offsets, n: int, k: int, passes: int, form: int,
                blocks: int):
    """The terms GS_MODEL weighs (gs_cost): 1, KB a block stages, passes,
    passes x blocks, passes x rounds of a block's row groups (the coop form:
    a warp a row, 8 rows a block, rounds of its grid; the staged forms: the
    most rows a block relaxes in a pass over GS_GROUPS), passes x KB a block
    reads a pass."""
    offs = [int(c) for c in color_offsets]
    widest = max(offs[c + 1] - offs[c] for c in range(len(offs) - 1))
    row_kb = (11.0 * k + 14.0) * 4.0 / 1024.0
    stage_kb = pass_kb = 0.0
    if form == GS_COOP:
        per = blocks * GS_ROWS_PER_BLOCK
        rounds = float(-(-widest // per))
        pass_kb = rounds * GS_ROWS_PER_BLOCK * row_kb
    else:
        wide = gs_layout_rows(offs, GS_STREAM, blocks)
        rounds = float(wide) / GS_GROUPS
        if form == GS_STREAM:
            pass_kb = wide * row_kb
        else:
            stage_kb = gs_smem_bytes(form, n, k, gs_layout_rows(
                offs, form, blocks)) / 1024.0
    return (1.0, stage_kb, float(passes), float(passes * blocks),
            passes * rounds, passes * pass_kb)


def gs_cost(color_offsets, n: int, k: int, passes: int, form: int,
            blocks: int) -> float:
    """The modelled device us of a call of `passes` passes (gs_cost)."""
    f = gs_features(color_offsets, n, k, passes, form, blocks)
    m = GS_MODEL[form]
    return (m[0] + m[1] * f[1] + m[2] * f[2] + m[3] * f[3] + m[4] * f[4]
            + m[5] * f[5])


def gs_coop_blocks(color_offsets, sms: int) -> int:
    """The blocks gs_cost counts for the coop form: a warp a row of the
    widest color, GS_ROWS_PER_BLOCK rows a block, at most 8 blocks an SM."""
    offs = [int(c) for c in color_offsets]
    widest = max(offs[c + 1] - offs[c] for c in range(len(offs) - 1))
    return min(-(-widest // GS_ROWS_PER_BLOCK), 8 * sms)


def gs_candidates(n: int, k: int, color_offsets, sms: int,
                  iterations: int):
    """[(modelled us, form, blocks)] of every launch ell_gs_plan weighs, in
    its order: the coop form, clusters of 1 to 16 blocks, 1 to `sms` blocks
    of the resident and stream forms, each within GS_SMEM_CAP."""
    offs = [int(c) for c in color_offsets]
    passes = len(gs_passes(offs, max(int(iterations), 1)))
    out = [(gs_cost(offs, n, k, passes, GS_COOP, gs_coop_blocks(offs, sms)),
            GS_COOP, 0)]
    for form in (GS_CLUSTER, GS_RESIDENT, GS_STREAM):
        top = GS_MAX_CLUSTER if form == GS_CLUSTER else sms
        for blocks in range(1, top + 1):
            rows = gs_layout_rows(offs, form, blocks)
            if gs_smem_bytes(form, n, k, rows) <= GS_SMEM_CAP:
                out.append((gs_cost(offs, n, k, passes, form, blocks), form,
                            blocks))
    return out


def gs_plan(n: int, k: int, color_offsets, sms: int, iterations: int):
    """(form, blocks) of a call of `iterations` as ell_gs_plan picks it on
    a card of `sms` SMs that places every cluster of up to 16 blocks: the
    least modelled cost, the first of a tie."""
    best = None
    for cost, form, blocks in gs_candidates(n, k, color_offsets, sms,
                                            iterations):
        if best is None or cost < best[0]:
            best = (cost, form, blocks)
    return best[1], best[2]


def _gs_plan(lib, n: int, k: int, offs, iterations: int, device):
    """ell_gs_plan's (form, blocks) for this call on this device, asked once
    per key (see _gs_plans)."""
    key = (str(device), n, k, tuple(offs), iterations)
    if key not in _gs_plans:
        plan = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            err = lib.ell_gs_plan(n, k, (ctypes.c_int * len(offs))(*offs),
                                  len(offs) - 1, iterations, plan)
        _cuda.check(err, "ell_gs_plan")
        _gs_plans[key] = (plan[0], plan[1])
    return _gs_plans[key]


def _offdiag_rows_plain(values, nbr, mask, diag_slot, x, r0: int, r1: int):
    """Rows [r0, r1) of sum over every slot but the diagonal's of
    A_ik (x[nbr_ik] mask_ik)."""
    slots = torch.arange(mask.shape[1], device=values.device)
    ds = diag_slot[r0:r1].long()
    off = slots[None, :] != ds[:, None]                   # (R, K)
    vals = torch.where(off[..., None, None], values[r0:r1],
                       torch.zeros_like(values[r0:r1]))
    xg = x[nbr[r0:r1].long()] * mask[r0:r1, :, None]
    return torch.einsum("nkji,nki->nj", vals, xg)


def _relax_rows_plain(values, nbr, mask, diag_slot, b, x, r0: int, r1: int):
    """Rows [r0, r1) of D^{-1} (b - sum over every slot but the diagonal's of
    A_ik (x[nbr_ik] mask_ik)): the kernels' row pass, step by step."""
    from . import ell
    rows = torch.arange(r0, r1, device=values.device)
    s = _offdiag_rows_plain(values, nbr, mask, diag_slot, x, r0, r1)
    return ell.solve3x3(values[rows, diag_slot[r0:r1].long()], b[r0:r1] - s)


def gs_plain(values, nbr, mask, diag_slot, color_offsets, b, x0=None,
             iterations: int = 1):
    """The kernel's plain version: colored symmetric Gauss-Seidel as ONE
    in-place pass per color (colors last to first, then first to last),
    in the kernel's passes (`gs_passes`: no color twice in a row)."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    for c in gs_passes(color_offsets, iterations):
        r0, r1 = int(color_offsets[c]), int(color_offsets[c + 1])
        x[r0:r1] = _relax_rows_plain(values, nbr, mask, diag_slot, b, x,
                                     r0, r1)
    return x


def jacobi_plain(values, nbr, mask, diag_slot, b, x0=None,
                 iterations: int = 2):
    """The kernel's plain version: every row relaxed against the previous
    iterate."""
    x = torch.zeros_like(b) if x0 is None else x0
    for _ in range(iterations):
        x = _relax_rows_plain(values, nbr, mask, diag_slot, b, x, 0,
                              values.shape[0])
    return x


def _check_smoother(values, nbr, mask, diag_slot, b, x0):
    n, k = _check(values, nbr, mask, b)
    _cuda.require(diag_slot, (n,), "diag_slot", dtype=torch.int32)
    if x0 is not None:
        _cuda.require(x0, (n, 3), "x0")
    return n, k


def gs(values, nbr, mask, diag_slot, color_offsets, b, x0=None,
       iterations: int = 1):
    """`iterations` colored symmetric Gauss-Seidel iterations of A x = b from
    x0 (zero by default; not modified), (N, 3). A in block-ELL form, its
    diagonal blocks at diag_slot (N,) int32; color c is the row range
    [color_offsets[c], color_offsets[c + 1]) and must be an independent set
    (`solvers.smoothers.EllOperator` checks it)."""
    tensors = (values, nbr, mask, diag_slot, b) + (() if x0 is None else (x0,))
    _cuda.refuse_grad("ell_kernels.gs", *tensors)
    n, k = _check_smoother(values, nbr, mask, diag_slot, b, x0)
    offs = [int(c) for c in color_offsets]
    nc = len(offs) - 1
    if not 1 <= nc <= 16 or offs[0] != 0 or offs[-1] != n or any(
            offs[c] > offs[c + 1] for c in range(nc)):
        raise ValueError(f"color_offsets {offs} do not partition [0, {n})")
    iterations = int(iterations)
    if iterations < 0:
        raise ValueError(f"iterations {iterations} < 0")
    if _cuda.on_cpu(*tensors):
        return gs_plain(values, nbr, mask, diag_slot, offs, b, x0, iterations)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    if iterations == 0:
        return x
    lib = _cuda.load()
    form, blocks = _gs_plan(lib, n, k, offs, iterations, b.device)
    with torch.cuda.device(b.device):
        err = lib.ell_gs(values.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                         diag_slot.data_ptr(), (ctypes.c_int * (nc + 1))(*offs),
                         nc, b.data_ptr(), x.data_ptr(), n, k, iterations,
                         form, blocks,
                         torch.cuda.current_stream(b.device).cuda_stream)
    launches["gs"] += 1
    key = (n, GS_FORMS[form])
    gs_launches[key] = gs_launches.get(key, 0) + 1
    _cuda.check(err, "ell_gs")
    return x


# ell_jacobi's forms (csrc/ell_kernels.cu, ell_jacobi_kernel): an
# iteration that gathers x, and the first from x0 = 0, which gathers nothing
JACOBI_FORMS = ("from x", "zero start")


def jacobi_lanes(n: int, sms: int) -> int:
    """The lanes a row of ell_jacobi and ell_jacobi_bwd at n rows on a card
    of `sms` SMs, as their C entries pick them (jacobi_lanes): the most of
    32 and 16 whose grid (256 / lanes rows a block) fits one wave at 8
    blocks an SM, else 8 (`scripts/jacobi_lanes.py` times each count)."""
    for lanes in (32, 16):
        if -(-n * lanes // 256) <= 8 * sms:
            return lanes
    return 8


def _jacobi_launch(values, nbr, mask, diag_slot, b, xa, xb,
                   iterations: int, zero_start: bool) -> None:
    """`iterations` ell_jacobi launches from xa (not read from the zero
    start), the result in xb for an odd count and in xa for an even one;
    counted by (rows, form)."""
    n, k = int(values.shape[0]), int(values.shape[1])
    lib = _cuda.load()
    stream = torch.cuda.current_stream(b.device).cuda_stream
    with torch.cuda.device(b.device):
        err = lib.ell_jacobi(values.data_ptr(), nbr.data_ptr(),
                             mask.data_ptr(), diag_slot.data_ptr(),
                             b.data_ptr(), xa.data_ptr(), xb.data_ptr(), n, k,
                             iterations, int(zero_start), stream)
    launches["jacobi"] += iterations       # one launch per iteration
    for it in range(iterations):
        key = (n, JACOBI_FORMS[int(zero_start and it == 0)])
        jacobi_launches[key] = jacobi_launches.get(key, 0) + 1
    _cuda.check(err, "ell_jacobi")


def _jacobi_step(values, nbr, mask, diag_slot, b, x):
    """One Jacobi iteration from x (None: the zero start) into a new tensor:
    plain on the CPU, else one launch."""
    if _cuda.on_cpu(values, b, *(() if x is None else (x,))):
        return _relax_rows_plain(values, nbr, mask, diag_slot, b,
                                 torch.zeros_like(b) if x is None else x, 0,
                                 values.shape[0])
    out = torch.empty_like(b)
    # one iteration reads xa and writes xb: x is not written
    _jacobi_launch(values, nbr, mask, diag_slot, b,
                   out if x is None else x, out, 1, x is None)
    return out


class EllJacobiFn(torch.autograd.Function):
    """`iterations` (>= 1) block-Jacobi iterations from x0 (zero for None),
    differentiable in values, b and x0. The forward keeps every iterate
    (one launch an iteration, each into its own output); the backward runs,
    last iteration first, one `jacobi_bwd` launch (lam, b's gradient, the
    diagonal blocks' and -lam (x) x_t into the off-diagonal slots) and,
    where the iterate before needs a gradient, `spmv_t` (-O^T lam, the
    diagonal slot left out). tt: A's transpose table
    (`transpose_table(nbr)`), or None where no gradient reaches an iterate
    before the last (`needs_table`)."""

    @staticmethod
    def forward(ctx, values, b, x0, nbr, mask, diag_slot, iterations, tt):
        if tt is None and needs_table(iterations, x0):
            raise ValueError(f"{iterations} Jacobi iterations from x0 "
                             f"{'None' if x0 is None else 'given'}: the "
                             "gradient needs A's transpose table tt")
        xs = [x0]                  # None: the zero start
        for _ in range(iterations):
            xs.append(_jacobi_step(values, nbr, mask, diag_slot, b, xs[-1]))
        ctx.save_for_backward(values, b, nbr, mask, diag_slot, tt, *xs[:-1])
        return xs[-1]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        values, b, nbr, mask, diag_slot, tt, *xs = ctx.saved_tensors
        need_v, need_b, need_x0 = ctx.needs_input_grad[:3]
        g = g.contiguous()
        gv = torch.empty_like(values) if need_v else None
        gb = torch.empty_like(b) if need_b else None
        cpu = not g.is_cuda        # any float dtype there (gradcheck)
        bwd = jacobi_bwd_plain if cpu else jacobi_bwd
        for t in range(len(xs) - 1, -1, -1):
            first = t == len(xs) - 1
            _count_call("jacobi_bwd", g)
            # xs[0] is None from the zero start: no x_t is read
            lam = bwd(values, nbr, mask, diag_slot, b, xs[t], g, gb, gv,
                      accumulate=not first)
            if t > 0 or need_x0:
                _count_call("spmv_t", g)
                g = (spmv_t_plain if cpu else spmv_t)(
                    values, mask, tt, lam, skip=diag_slot, alpha=-1.0)
        return (gv, gb, g if need_x0 else None, None, None, None, None,
                None)


def needs_table(iterations: int, x0) -> bool:
    """Whether the gradient of `iterations` Jacobi iterations from x0 runs
    through A^T (an iterate before the last, or x0, takes a gradient)."""
    return iterations > 1 or (x0 is not None and x0.requires_grad)


def jacobi(values, nbr, mask, diag_slot, b, x0=None, iterations: int = 2,
           tt=None):
    """`iterations` block-Jacobi iterations x <- D^{-1} (b - (L + U) x) from
    x0 (zero by default; not modified), (N, 3). Differentiable in values, b
    and x0 (`EllJacobiFn`; tt: A's transpose table, required when the
    gradient runs through A^T, `needs_table`)."""
    tensors = (values, nbr, mask, diag_slot, b) + (() if x0 is None else (x0,))
    _check_smoother(values, nbr, mask, diag_slot, b, x0)
    iterations = int(iterations)
    if iterations < 0:
        raise ValueError(f"iterations {iterations} < 0")
    if iterations == 0:
        _cuda.on_cpu(*tensors)
        return torch.zeros_like(b) if x0 is None else x0.clone()
    if _cuda.records_grad(values, b, x0, mask):
        _cuda.refuse_grad("mask, a 0/1 table,", mask)
        return EllJacobiFn.apply(values, b, x0, nbr, mask, diag_slot,
                                 iterations, tt)
    if _cuda.on_cpu(*tensors):
        return jacobi_plain(values, nbr, mask, diag_slot, b, x0, iterations)
    # from the zero start xa is only written (at the second iteration)
    xa = torch.empty_like(b) if x0 is None else x0.clone()
    xb = torch.empty_like(xa)
    _jacobi_launch(values, nbr, mask, diag_slot, b, xa, xb, iterations,
                   x0 is None)
    return xb if iterations % 2 else xa
