"""The device grid, the exchange layer, and the data-parallel batched step.

Port of `fem_simulation_tpu/parallel/dist.py`. The JAX package is one
program over a `(dp, sp)` device mesh: `shard_map` hands each device its
block of an array and `ppermute` / `psum` move data between the blocks. The
port keeps that single-controller design in one process: a `DeviceGrid` is
a `(dp, sp)` array of torch devices, a distributed field is a list of
blocks (block i on the grid's device i along the axis), and the collectives
below move blocks between those devices.

    dp  a batch of independent scenes; scenes never communicate.
    sp  the spatial axis: z-slabs of a lattice (parallel/lattice_halo.py,
        parallel/lattice_mg_dist.py) or of an unstructured mesh
        (parallel/halo.py), with an explicit plane or row halo exchange.

A grid may hold more entries than there are cards: the entries then repeat
a card (`DeviceGrid.shared`), so D slabs can share one GPU and the exchange,
the fold and the kernels at slab shapes all run on it. Where the entries are
distinct cards, an exchange is a peer copy.

Every collective counts its calls and the bytes it moves between blocks in
`counts` (zero them with `reset_counts`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import require_cuda
from ..config import DynamicsConfig
from ..sim import dynamic
from ..sim.scene import Scene
from ..solvers import cg as cgmod

# shift: shift_planes calls; planes: the blocks they were given (one plane
# or send buffer a block a call, as a ppermute takes one operand a device);
# bytes: what moved from one block to another; psum / pmax: reductions
counts = {"shift": 0, "planes": 0, "bytes": 0, "psum": 0, "pmax": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


def canonical_device(device) -> torch.device:
    """A torch.device with its CUDA index filled in."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceGrid:
    """A (dp, sp) array of torch devices with the axis names ("dp", "sp"),
    the counterpart of a jax.sharding.Mesh over those axes."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        flat = [str(d) for d in devices.reshape(-1)]
        # entries repeat a device (D slabs on one card, or on the CPU)
        self.shared = len(set(flat)) < len(flat)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The grid's first device: where reductions land."""
        return self.devices[0, 0]

    def line(self, axis: str = "sp", index: int = 0) -> list:
        """The devices along `axis` at position `index` of the other axis."""
        if axis == "sp":
            return list(self.devices[index, :])
        if axis == "dp":
            return list(self.devices[:, index])
        raise ValueError(f"axis {axis!r}: 'dp' or 'sp'")

    def __repr__(self) -> str:
        names = np.vectorize(str)(self.devices)
        return (f"DeviceGrid({self.shape}, shared={self.shared}, "
                f"devices={names.tolist()})")


def make_device_mesh(n_devices: int | None = None, dp: int | None = None,
                     device=None) -> DeviceGrid:
    """A (dp, sp) DeviceGrid of n_devices entries (dp defaults to 2 where
    n_devices is even, else 1: 8 -> 2 x 4, 1 -> 1 x 1).

    With no `device` the entries are the visible GPUs (raises where there is
    none), n_devices defaults to their count, and entries beyond it repeat
    them in turn. `device="cpu"` builds CPU entries (n_devices defaults to
    1); a device with an index ("cuda:1") fills every entry with that card.
    """
    if device is None:
        require_cuda()
        device = "cuda"
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [canonical_device(d)]
    n = n_devices if n_devices is not None else len(cards)
    if dp is None:
        dp = 2 if (n % 2 == 0 and n >= 2) else 1
    sp = n // dp
    if dp * sp != n:
        raise ValueError(f"{dp}x{sp} != {n}")
    devs = np.empty((n,), dtype=object)
    for i in range(n):
        devs[i] = cards[i % len(cards)]
    return DeviceGrid(devs.reshape(dp, sp))


# -- collectives ---------------------------------------------------------------

def shift_planes(bufs: list, step: int) -> list:
    """The non-circular ppermute: out[i] = bufs[i - step] on bufs[i]'s
    device (step +1: each block sends to the next, perm [(i, i+1)]; -1: to
    the previous, [(i+1, i)]). The block with no source gets None, standing
    for the zeros ppermute delivers there. Buffers of any shape (a vertex
    plane, a send list) of one shape for every block."""
    n = len(bufs)
    out = [None] * n
    for i in range(n):
        j = i - step
        if 0 <= j < n:
            out[i] = bufs[j].to(bufs[i].device, non_blocking=True)
            counts["bytes"] += bufs[j].numel() * bufs[j].element_size()
    counts["shift"] += 1
    counts["planes"] += n
    return out


def psum(vals: list) -> torch.Tensor:
    """The sum of per-block 0-d partials, in block order, as a 0-d tensor
    on the first block's device."""
    dev = vals[0].device
    counts["psum"] += 1
    return torch.stack([v.to(dev, non_blocking=True) for v in vals]).sum()


def pmax(vals: list) -> torch.Tensor:
    """The largest of per-block 0-d values (NaN propagates), on the first
    block's device."""
    dev = vals[0].device
    counts["pmax"] += 1
    return torch.max(torch.stack([v.to(dev, non_blocking=True)
                                  for v in vals]))


def dot(a: list, b: list) -> torch.Tensor:
    """The dot product of two distributed fields: a psum of the blocks'
    partials."""
    return psum([torch.sum(x * y) for x, y in zip(a, b)])


def inf_norm(blocks: list) -> np.float32:
    """max |entry| of a distributed field (a pmax), read back to the host."""
    return np.float32(pmax([torch.max(torch.abs(b)) for b in blocks]).item())


def _on(s, like):
    return s.to(like.device, non_blocking=True)


def dist_pcg(matvec, minv, f: list, iterations: int, tol: float) -> list:
    """Preconditioned CG on distributed fields from zero, as the reference's
    distributed steps run it: at most `iterations` matvecs, stopping when
    r.r <= tol * r0.r0 or r.r is not finite; alpha = rz / max(p.Ap, 1e-30).
    Every dot product is a psum; the loop reads its condition back once an
    iteration."""
    xs = [torch.zeros_like(b) for b in f]
    r = f
    z = minv(r)
    p = z
    rz = dot(r, z)
    rr0 = dot(r, r)
    rr = rr0
    i = 1
    while i <= iterations and bool((rr > tol * rr0) & torch.isfinite(rr)):
        ap = matvec(p)
        alpha = rz / torch.clamp(dot(p, ap), min=1e-30)
        xs = [x + _on(alpha, x) * pb for x, pb in zip(xs, p)]
        r = [rb - _on(alpha, rb) * a for rb, a in zip(r, ap)]
        z = minv(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = [zb + _on(beta, zb) * pb for zb, pb in zip(z, p)]
        rz = rz_new
        rr = dot(r, r)
        i += 1
    return xs


def dist_newton_frame(x: list, v: list, resid, solve, mask: list, dt: float,
                      damping: float, tol: float, max_newton: int):
    """One implicit-Euler frame on distributed fields, the reference's
    distributed step: predictor, then Newton (x += solve(x, f) * mask) while
    cgmod.newton_cond holds. resid(x, x_tilde) -> f. Returns (x, v,
    newton_iters, f_inf)."""
    x_old = x
    v = [vb * damping for vb in v]
    x = [xb + vb * dt for xb, vb in zip(x, v)]
    x_tilde = x
    cond = cgmod.newton_cond(tol, max_newton)
    fn = inf_norm(resid(x, x_tilde))
    fmin, k = fn, 0
    while cond((x, k, fn, fmin)):
        dx = solve(x, resid(x, x_tilde))
        x = [xb + d * m for xb, d, m in zip(x, dx, mask)]
        fn = inf_norm(resid(x, x_tilde))
        k += 1
        fmin = np.minimum(fmin, fn)
    v = [(xb - xo) * (1.0 / dt) for xb, xo in zip(x, x_old)]
    return x, v, k, cgmod.newton_exit_norm(fn, fmin)


def to_device(obj, device):
    """Tensors of a nested dict / list / tuple moved to `device`."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


# -- the data-parallel batched step ---------------------------------------------

def make_batched_step(scene: Scene, grid: DeviceGrid, batch: int,
                      dyn: DynamicsConfig = DynamicsConfig()):
    """A batch of `batch` copies of the scene, split over the grid's dp
    axis: (step_fn, params, state0).

    params is one params dict per dp row (the scene's own where the row is
    the scene's device, a copy elsewhere); state0 one DynState per row, its
    tensors (batch / dp, ...) on that row's device. step_fn(params, states)
    -> states steps every scene once by `dynamic.step` (one Newton solve,
    its CG through the block-ELL SpMV); a row's scenes run one after
    another. Vertices are not split over sp: the GSPMD split of the JAX
    package has no counterpart here, and the explicit spatial paths are
    parallel/halo.py and parallel/lattice_halo.py."""
    dp = grid.shape["dp"]
    if batch % dp:
        raise ValueError(f"batch {batch} does not split over dp = {dp}")
    per = batch // dp
    rows = [canonical_device(d) for d in grid.line("dp")]
    home = scene.x0.device
    params = [scene.params if d == home else to_device(scene.params, d)
              for d in rows]
    st = dynamic.init_state(scene)

    def rep(a, d):
        return a.to(d).unsqueeze(0).expand((per,) + tuple(a.shape)) \
            .contiguous()
    state0 = [dynamic.DynState(x=rep(st.x, d), v=rep(st.v, d),
                               drag_mask=rep(st.drag_mask, d),
                               drag_pos=rep(st.drag_pos, d)) for d in rows]

    def step_fn(params, states):
        out = []
        for p, s in zip(params, states):
            done = [dynamic.step(scene, p, dynamic.DynState(
                *(a[b] for a in s)), dyn) for b in range(s.x.shape[0])]
            out.append(dynamic.DynState(*(torch.stack(list(f))
                                          for f in zip(*done))))
        return out

    return step_fn, params, state0


def stack_batch(states: list) -> dynamic.DynState:
    """The rows of a batched state as one DynState (B, ...) on the first
    row's device."""
    dev = states[0].x.device
    return dynamic.DynState(*(torch.cat([a.to(dev) for a in f])
                              for f in zip(*states)))
