"""Checkpoint / resume and metrics logging.

Port of `fem_simulation_tpu/utils/io.py` with the same npz layout, so a
file written by either package loads in the other:

- `save_state` / `load_state`: a NamedTuple or dict of arrays, one npz key
  per field, extra values under "extra_<name>";
- `checkpoint_sim` / `resume_sim`: a DynamicSim's state fields, or a
  QuasiStaticSim's x under "x";
- `save_pytree` / `load_pytree`: the leaves of nested dicts, lists and
  tuples (and NamedTuples) as arr_0, arr_1, ... in `jax.tree_util`'s
  flatten order (dict keys sorted, None holding no leaf), and a `.tree`
  sidecar with the structure written as `str(treedef)` writes it.

Tensors are read back to the host on save; loads put them on `device`.
"""
from __future__ import annotations

import csv
import json
import os
import time

import numpy as np
import torch

from .. import device_or_cuda


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def save_state(path: str, state, extra: dict | None = None):
    """Save a NamedTuple or dict of arrays to .npz."""
    if hasattr(state, "_asdict"):
        items = state._asdict().items()
    elif isinstance(state, dict):
        items = state.items()
    else:
        raise TypeError(type(state))
    flat = {k: _np(v) for k, v in items}
    for k, v in (extra or {}).items():
        flat[f"extra_{k}"] = _np(v)
    np.savez(path, **flat)


def load_state(path: str, state_cls=None, device=None):
    """Load what save_state wrote: (dict or state_cls of tensors on
    `device`, the GPU by default; dict of extra numpy arrays)."""
    device = device_or_cuda(device)
    with np.load(path, allow_pickle=False) as data:
        fields = {k: torch.from_numpy(data[k]).to(device) for k in data.files
                  if not k.startswith("extra_")}
        extra = {k[len("extra_"):]: data[k] for k in data.files
                 if k.startswith("extra_")}
    if state_cls is not None:
        return state_cls(**fields), extra
    return fields, extra


def _flatten(tree):
    """(leaves, structure string) in jax.tree_util's order and notation."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, s = _flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {s}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for v in tree:
            sub, s = _flatten(v)
            leaves += sub
            parts.append(s)
        body = ", ".join(parts)
        if hasattr(tree, "_fields"):
            return leaves, (f"CustomNode(namedtuple[{type(tree).__name__}], "
                            f"[{body}])")
        if isinstance(tree, list):
            return leaves, f"[{body}]"
        return leaves, f"({body},)" if len(tree) == 1 else f"({body})"
    return [tree], "*"


def _unflatten(like, leaves):
    """`like` with its leaves replaced, in _flatten's order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, leaves) for v in like]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    return next(leaves)


def _base(path: str) -> str:
    return path[:-len(".npz")] if path.endswith(".npz") else path


def save_pytree(path: str, tree):
    """Pickle-free pytree save: leaf arrays as npz in flatten order, the
    structure as text in `path.tree`. Pair with load_pytree(path, like)."""
    leaves, structure = _flatten(tree)
    np.savez(path, *[_np(l) for l in leaves])
    with open(_base(path) + ".tree", "w") as fh:
        fh.write(f"PyTreeDef({structure})")


def load_pytree(path: str, like):
    """Load arrays saved by save_pytree into the structure of `like`.

    Leaves are matched by flatten order and shape-checked, and become
    tensors on the device of the leaf of `like` they replace (the CPU for
    a leaf that is no tensor). When the `.tree` sidecar exists its structure
    must match `like`'s: flatten order and shapes alone cannot tell two
    same-shaped fields apart."""
    base = _base(path)
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        leaves = [data[k] for k in data.files]
    like_leaves, structure = _flatten(like)
    expected = f"PyTreeDef({structure})"
    sidecar = base + ".tree"
    if os.path.exists(sidecar):
        with open(sidecar) as fh:
            saved = fh.read()
        if saved != expected:
            raise ValueError(
                f"{path}: saved tree structure does not match `like`:\n"
                f"  saved:    {saved}\n  expected: {expected}")
    if len(leaves) != len(like_leaves):
        raise ValueError(f"{path}: {len(leaves)} saved leaves, structure "
                         f"expects {len(like_leaves)}")
    out = []
    for i, (l, ref) in enumerate(zip(leaves, like_leaves)):
        if hasattr(ref, "shape") and tuple(l.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: leaf {i} shape {l.shape} != "
                             f"expected {tuple(ref.shape)}")
        dev = ref.device if torch.is_tensor(ref) else "cpu"
        out.append(torch.from_numpy(l).to(dev))
    return _unflatten(like, iter(out))


def checkpoint_sim(path: str, sim):
    """Checkpoint a DynamicSim / ClothSim (its state) or a QuasiStaticSim
    (its x) for resume."""
    if hasattr(sim, "state"):
        save_state(path, sim.state)
    else:
        np.savez(path, x=_np(sim.x))


def resume_sim(path: str, sim):
    """Load a checkpoint into `sim`, on the device its state lives on."""
    with np.load(path, allow_pickle=False) as data:
        if hasattr(sim, "state"):
            dev = sim.state.x.device
            sim.state = type(sim.state)(**{
                k: torch.from_numpy(data[k]).to(dev) for k in data.files})
        else:
            sim.x = torch.from_numpy(data["x"]).to(sim.x.device)
    return sim


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

class MetricsLogger:
    """Structured per-step metrics: in-memory series + optional CSV/JSONL."""

    def __init__(self, csv_path: str | None = None,
                 jsonl_path: str | None = None):
        self.series: dict[str, list] = {}
        self._csv_path = csv_path
        self._jsonl_path = jsonl_path
        self._csv_writer = None
        self._csv_file = None

    def log(self, step: int, **metrics):
        row = {"step": step, "time": time.time(), **{
            k: float(v) for k, v in metrics.items()}}
        for k, v in row.items():
            self.series.setdefault(k, []).append(v)
        if self._jsonl_path:
            with open(self._jsonl_path, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        if self._csv_path:
            if self._csv_writer is None:
                self._csv_file = open(self._csv_path, "w", newline="")
                self._csv_writer = csv.DictWriter(self._csv_file,
                                                  fieldnames=list(row))
                self._csv_writer.writeheader()
            self._csv_writer.writerow(row)
            self._csv_file.flush()

    def get(self, key: str) -> np.ndarray:
        return np.asarray(self.series.get(key, []))

    def close(self):
        if self._csv_file:
            self._csv_file.close()
            self._csv_file = None
            self._csv_writer = None
