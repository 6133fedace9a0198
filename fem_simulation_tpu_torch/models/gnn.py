"""exp3 neural models: GraphConv encoder + per-axis MLP decoders (torch.nn).

Port of `fem_simulation_tpu/models/gnn.py` (flax.linen). GraphConv keeps
the JAX package's semantics, torch_geometric's GraphConv with mean
aggregation by default: x_i' = W1 x_i + b + W2 agg_{j->i} x_j. The JAX
package's scatter-add `.at[dst].add(x[src])` becomes a gather through an
in-neighbour table built once on the host (`Graph`): row i lists the
sources of the edges into i in edge order, padded with the index of an
appended zero row, so every sum runs in the same order on every call.

Models:
  Encoder     - 2x GraphConv + Linear
  Decoder     - D-layer ELU MLP
  MDN3        - encoder + 3 per-axis decoders
  MultiLevel3 - per-level encoders; coarse features prolongated to the fine
                grid, concatenated, shared decoders

Weights are initialised as flax's Dense does (LeCun normal, truncated at two
standard deviations; zero biases) from a `torch.Generator`: the same
distribution as the JAX package, not the same numbers. `params_from_flax`
carries a flax parameter tree across (a Dense kernel is (in, out), a torch
Linear weight (out, in)).
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops import take_rows

# std of a standard normal truncated to [-2, 2] (flax's truncated_normal)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None):
    """flax.linen.Dense's kernel init on a torch (out, in) weight: variance
    1 / fan_in, a normal truncated at two standard deviations."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        w = torch.empty(weight.shape, dtype=weight.dtype)
        nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                              generator=generator)
        weight.copy_(w * std)
    return weight


def dense(n_in: int, n_out: int, bias: bool = True,
          generator: torch.Generator | None = None) -> nn.Linear:
    """A Linear initialised as flax's Dense."""
    lin = nn.Linear(n_in, n_out, bias=bias)
    lecun_normal_(lin.weight, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class Graph(NamedTuple):
    """A directed graph as GraphConv gathers it."""
    table: torch.Tensor      # (N, D) int64: sources of the edges into i, pad N
    deg: torch.Tensor        # (N,) float32: in-degree


def edge_index_from_topology(nbr, nbr_mask) -> np.ndarray:
    """Directed (2, E) int32 edge list (both directions, no self-loops) from
    the block-ELL neighbor table: src = nbr[i, k], dst = i over the live
    off-diagonal slots, rows ascending."""
    nbr = np.asarray(nbr.detach().cpu() if torch.is_tensor(nbr) else nbr)
    mask = np.asarray(nbr_mask.detach().cpu() if torch.is_tensor(nbr_mask)
                      else nbr_mask) > 0
    n = nbr.shape[0]
    rows = np.repeat(np.arange(n), nbr.shape[1]).reshape(n, -1)
    sel = mask & (nbr != rows)
    src = nbr[sel].astype(np.int32)
    dst = rows[sel].astype(np.int32)
    return np.stack([src, dst])


def graph_from_edge_index(edge_index, n: int, device=None) -> Graph:
    """The in-neighbour table of a (2, E) edge list (messages src -> dst):
    row i lists src[m] for the edges m into i in increasing m, padded with
    n (the zero row GraphConv appends); built on the host."""
    ei = np.asarray(edge_index.detach().cpu() if torch.is_tensor(edge_index)
                    else edge_index).astype(np.int64)
    src, dst = ei[0], ei[1]
    order = np.argsort(dst, kind="stable")
    d_sorted = dst[order]
    pos = np.arange(dst.size) - np.searchsorted(d_sorted, d_sorted)
    depth = int(pos.max()) + 1 if dst.size else 1
    table = np.full((n, depth), n, dtype=np.int64)
    table[d_sorted, pos] = src[order]
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    return Graph(torch.from_numpy(table).to(device),
                 torch.from_numpy(deg).to(device))


def graph_from_topology(nbr, nbr_mask, device=None) -> Graph:
    """`graph_from_edge_index(edge_index_from_topology(nbr, nbr_mask))`."""
    return graph_from_edge_index(edge_index_from_topology(nbr, nbr_mask),
                                 int(np.asarray(nbr.shape[0])), device)


class GraphConv(nn.Module):
    """x_i' = W1 x_i + b + W2 agg_{j->i} x_j; aggr "mean" (the JAX
    package's default: hex-lattice vertices have ~26 neighbours, and sums
    grow the activations ~26x a layer) or "add"."""

    def __init__(self, n_in: int, features: int, aggr: str = "mean",
                 generator: torch.Generator | None = None):
        super().__init__()
        if aggr not in ("mean", "add"):
            raise ValueError(f"aggr {aggr!r}")
        self.aggr = aggr
        self.root = dense(n_in, features, True, generator)
        self.rel = dense(n_in, features, False, generator)

    def forward(self, x, graph: Graph):
        src = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        agg = take_rows(src, graph.table).sum(dim=1)
        if self.aggr == "mean":
            agg = agg / torch.clamp(graph.deg, min=1.0)[:, None]
        return self.root(x) + self.rel(agg)


class Encoder(nn.Module):
    def __init__(self, n_in: int, hidden: int, n_outputs: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.convs = nn.ModuleList(
            [GraphConv(n_in, hidden, generator=generator),
             GraphConv(hidden, hidden, generator=generator)])
        self.out = dense(hidden, n_outputs * 3, True, generator)

    def forward(self, x, graph: Graph):
        for conv in self.convs:
            x = F.relu(conv(x, graph))
        return self.out(x)


class Decoder(nn.Module):
    def __init__(self, n_in: int, depth: int = 1, width: int = 64,
                 out: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        dims = [n_in] + [width] * depth
        self.layers = nn.ModuleList(
            [dense(a, b, True, generator) for a, b in zip(dims, dims[1:])]
            + [dense(dims[-1], out, True, generator)])

    def forward(self, x):
        for lin in self.layers[:-1]:
            x = F.elu(lin(x))
        return self.layers[-1](x)


class MDN3(nn.Module):
    """Encoder to (N, 3, feat); three per-axis decoders to (N, 3)."""

    def __init__(self, n_in: int = 6, feat_dim: int = 4, hidden: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.feat_dim = feat_dim
        self.encoders = nn.ModuleList([Encoder(n_in, hidden, feat_dim,
                                               generator)])
        self.decoders = nn.ModuleList([Decoder(feat_dim, generator=generator)
                                       for _ in range(3)])

    def forward(self, x, graph: Graph):
        h = self.encoders[0](x, graph).reshape(x.shape[0], 3, self.feat_dim)
        return torch.cat([dec(h[:, i, :]) for i, dec in
                          enumerate(self.decoders)], dim=-1)


class MultiLevel3(nn.Module):
    """Per-level encoders; coarse features prolongated to the fine grid and
    concatenated along the feature axis; shared per-axis decoders.

    `prolongs` is a list of callables (one per coarse level) mapping that
    level's (N_l, F) features to fine (N_0, F) features."""

    def __init__(self, n_levels: int, n_in: int = 6, feat_dim: int = 4,
                 hidden: int = 64, generator: torch.Generator | None = None):
        super().__init__()
        self.n_levels, self.feat_dim = n_levels, feat_dim
        self.encoders = nn.ModuleList([Encoder(n_in, hidden, feat_dim,
                                               generator)
                                       for _ in range(n_levels)])
        self.decoders = nn.ModuleList([Decoder(feat_dim * n_levels,
                                               generator=generator)
                                       for _ in range(3)])

    def forward(self, xs: Sequence, graphs: Sequence, prolongs):
        n0 = xs[0].shape[0]
        feats = []
        for li, enc in enumerate(self.encoders):
            h = enc(xs[li], graphs[li])
            if li > 0:
                h = prolongs[li - 1](h)
            feats.append(h.reshape(n0, 3, self.feat_dim))
        h = torch.cat(feats, dim=2)                 # (N, 3, feat*levels)
        return torch.cat([dec(h[:, i, :]) for i, dec in
                          enumerate(self.decoders)], dim=-1)


# flax auto-name -> the port's module name, per parent kind
_RENAMES = {
    "model": {"Encoder": "encoders", "Decoder": "decoders"},
    "Encoder": {"GraphConv": "convs", "Dense": "out"},
    "GraphConv": {"Dense": ("root", "rel")},
    "Decoder": {"Dense": "layers"},
}


def params_from_flax(tree) -> dict:
    """The port's state_dict (float32 CPU tensors) of MDN3 / MultiLevel3
    from the flax parameter tree of the JAX models (nested dicts of numpy
    arrays, with or without the top-level "params" key): Encoder_i ->
    encoders.i, Decoder_i -> decoders.i; in an encoder GraphConv_i ->
    convs.i, Dense_0 -> out; in a GraphConv Dense_0 -> root, Dense_1 ->
    rel; in a decoder Dense_i -> layers.i; kernel (in, out) -> weight
    (out, in), bias -> bias."""
    if "params" in tree:
        tree = tree["params"]
    out = {}

    def walk(node, kind, prefix):
        for name, sub in node.items():
            if name in ("kernel", "bias"):
                a = np.asarray(sub, dtype=np.float32)
                key = "weight" if name == "kernel" else "bias"
                out[prefix + key] = torch.from_numpy(
                    np.ascontiguousarray(a.T if name == "kernel" else a))
                continue
            m = re.fullmatch(r"([A-Za-z]+)_(\d+)", name)
            if m is None or m.group(1) not in _RENAMES[kind]:
                raise ValueError(f"unexpected flax module {prefix}{name!r} "
                                 f"in a {kind}")
            sub_kind, idx = m.group(1), int(m.group(2))
            target = _RENAMES[kind][sub_kind]
            if isinstance(target, tuple):        # GraphConv's two Denses
                path = target[idx]
            elif kind == "Encoder" and sub_kind == "Dense":
                path = target
            else:
                path = f"{target}.{idx}"
            walk(sub, sub_kind, prefix + path + ".")

    walk(tree, "model", "")
    return out
