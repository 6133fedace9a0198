"""Level fields kept in z-slabs between operators.

A field of a level whose z extent is split into D equal slabs (the
distributed multigrid's sharded levels, parallel/lattice_mg_dist.py) lives
as one tensor per device group: the consecutive slabs whose grid entries
are the same device, stacked on a leading axis, channel-first with z last,
(s, C..., X, Y, z) for a group of s slabs of z planes. Slab i of a group is
`part[i]`, a contiguous block, so a per-slab kernel reads it as it reads a
slab of its own.

On D cards each group holds one slab; where the slabs share a card (one
H100, or the CPU) the one group holds all D, and an elementwise operation
is one launch over the level. `slab_groups` is the one rule that forms the
groups.

Between neighbouring slabs of a group the ghost planes of `extend` and
`fold` are shifted slices; between groups they are `dist.shift_planes`.
Either way `dist.counts` counts one plane a slab for each exchange, as for
a list of blocks (parallel/lattice_halo.py).
"""
from __future__ import annotations

import torch

from . import dist


def slab_groups(devices) -> list:
    """(start, stop) of each run of equal consecutive entries of `devices`:
    the slabs of one run share a device and form one group."""
    out = []
    for i, d in enumerate(devices):
        if out and devices[out[-1][0]] == d:
            out[-1] = (out[-1][0], i + 1)
        else:
            out.append((i, i + 1))
    return out


class SlabLayout:
    """D z-slabs on `devices` (one entry a slab), grouped by slab_groups."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.n = len(self.devices)
        self.groups = slab_groups(self.devices)

    def split(self, whole) -> "SlabField":
        """A whole field (..., Z) as slabs of Z / D planes: one copy a
        group, onto the group's device."""
        z = whole.shape[-1] // self.n
        lead = tuple(whole.shape[:-1])
        return SlabField(self, [
            whole[..., a * z:b * z].reshape(lead + (b - a, z)).movedim(-2, 0)
            .contiguous().to(self.devices[a], non_blocking=True)
            for a, b in self.groups])

    def stack(self, slabs: list) -> "SlabField":
        """One tensor a slab (in slab order, each on its group's device) as
        a SlabField."""
        return SlabField(self, [slabs[a].unsqueeze(0) if b - a == 1
                                else torch.stack(slabs[a:b])
                                for a, b in self.groups])


def _count_inner(layout: SlabLayout, plane) -> None:
    """The planes a shift moved inside groups, as shift_planes counts its
    own: one plane and its bytes a slab with a source."""
    inner = layout.n - len(layout.groups)
    dist.counts["planes"] += inner
    dist.counts["bytes"] += inner * plane.numel() * plane.element_size()


def _align(a, b):
    """A scalar field (s, X, Y, z) against a vector or block field
    (s, C, X, Y, z): a unit channel axis after the slab axis."""
    while a.dim() < b.dim():
        a = a.unsqueeze(1)
    while b.dim() < a.dim():
        b = b.unsqueeze(1)
    return a, b


class SlabField:
    """A level field as one tensor a device group (see the module
    docstring). Arithmetic with a scalar, a 0-d tensor (moved to each
    group's device), or a SlabField of the same layout (a scalar field
    broadcasts over the channels) acts on each group tensor."""

    __array_ufunc__ = None   # numpy scalars defer to the reflected ops

    def __init__(self, layout: SlabLayout, parts: list):
        self.layout = layout
        self.parts = parts

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The first group's device: where reductions land."""
        return self.parts[0].device

    def zeros_like(self) -> "SlabField":
        return SlabField(self.layout, [torch.zeros_like(p)
                                       for p in self.parts])

    def slabs(self):
        """Each slab's block, in slab order: views into the group tensors."""
        return [p[i] for p in self.parts for i in range(p.shape[0])]

    def join(self, device):
        """The whole field (..., Z) on `device`."""
        out = [p.movedim(0, -2).reshape(tuple(p.shape[1:-1]) + (-1,))
               .to(device, non_blocking=True) for p in self.parts]
        return out[0] if len(out) == 1 else torch.cat(out, -1)

    @staticmethod
    def apply(fn, *args) -> "SlabField":
        """fn on each group: SlabField arguments give their group tensor,
        the others pass as they are."""
        layout = next(a.layout for a in args if isinstance(a, SlabField))
        return SlabField(layout, [
            fn(*(a.parts[g] if isinstance(a, SlabField) else a
                 for a in args)) for g in range(len(layout.groups))])

    def _binary(self, other, fn):
        if isinstance(other, SlabField):
            return SlabField(self.layout, [fn(*_align(a, b)) for a, b in
                                           zip(self.parts, other.parts)])
        if torch.is_tensor(other):
            if other.dim():
                raise TypeError(f"a SlabField and a whole tensor of shape "
                                f"{tuple(other.shape)}")
            return SlabField(self.layout, [
                fn(a, other.to(a.device, non_blocking=True))
                for a in self.parts])
        return SlabField(self.layout, [fn(a, other) for a in self.parts])

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binary(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._binary(other, lambda a, b: a / b)

    def dot(self, other) -> torch.Tensor:
        """The dot product as dist.dot takes it of a list of slabs: each
        slab's partial, summed in slab order (a psum) on the first group's
        device."""
        return dist.psum([torch.sum(a[i] * b[i])
                          for a, b in zip(self.parts, other.parts)
                          for i in range(a.shape[0])])

    def inf_norm(self) -> torch.Tensor:
        """max |entry| as a 0-d tensor on the first group's device: a pmax
        of the groups' maxima, bit-equal to the whole field's (NaN
        propagates)."""
        return dist.pmax([torch.max(torch.abs(p)) for p in self.parts])

    # -- the plane halo -----------------------------------------------------
    def extend(self) -> "SlabField":
        """Owned planes (..., z) -> (..., z + 2) with a ghost plane a side
        holding the neighbours' owned boundary planes (zeros past either
        end of the lattice)."""
        lo = dist.shift_planes([p[-1, ..., -1] for p in self.parts], +1)
        hi = dist.shift_planes([p[0, ..., 0] for p in self.parts], -1)
        out = []
        for p, l, h in zip(self.parts, lo, hi):
            e = p.new_empty(tuple(p.shape[:-1]) + (p.shape[-1] + 2,))
            e[..., 1:-1] = p
            e[1:, ..., 0] = p[:-1, ..., -1]
            e[:-1, ..., -1] = p[1:, ..., 0]
            e[0, ..., 0] = 0.0 if l is None else l
            e[-1, ..., -1] = 0.0 if h is None else h
            out.append(e)
        for _ in range(2):
            _count_inner(self.layout, self.parts[0][0, ..., 0])
        return SlabField(self.layout, out)

    def fold(self) -> "SlabField":
        """Ghost-extended partial sums (..., z + 2) -> the owned planes
        (..., z), each ghost plane added into the neighbour's boundary
        plane (from the left first, then from the right)."""
        left = dist.shift_planes([e[-1, ..., -1] for e in self.parts], +1)
        right = dist.shift_planes([e[0, ..., 0] for e in self.parts], -1)
        out = []
        for e, l, r in zip(self.parts, left, right):
            o = e[..., 1:-1].contiguous()
            o[1:, ..., 0] += e[:-1, ..., -1]
            if l is not None:
                o[0, ..., 0] += l
            o[:-1, ..., -1] += e[1:, ..., 0]
            if r is not None:
                o[-1, ..., -1] += r
            out.append(o)
        for _ in range(2):
            _count_inner(self.layout, self.parts[0][0, ..., 0])
        return SlabField(self.layout, out)

    def neighbor_plane(self, step: int) -> list:
        """Per group, (s, ..., X, Y): the previous slab's last plane (step
        +1) or the next slab's first plane (step -1), zeros past either
        end; one shift_planes."""
        idx = -1 if step > 0 else 0
        recv = dist.shift_planes(
            [p[-1 if step > 0 else 0, ..., idx] for p in self.parts], step)
        out = []
        for p, r in zip(self.parts, recv):
            o = torch.zeros_like(p[..., idx])
            if step > 0:
                o[1:] = p[:-1, ..., idx]
                if r is not None:
                    o[0] = r
            else:
                o[:-1] = p[1:, ..., idx]
                if r is not None:
                    o[-1] = r
            out.append(o)
        _count_inner(self.layout, self.parts[0][0, ..., 0])
        return out

    def ghost_zero(self) -> "SlabField":
        """(..., z) -> (..., z + 2) with zero ghost planes."""
        out = []
        for p in self.parts:
            e = p.new_zeros(tuple(p.shape[:-1]) + (p.shape[-1] + 2,))
            e[..., 1:-1] = p
            out.append(e)
        return SlabField(self.layout, out)
