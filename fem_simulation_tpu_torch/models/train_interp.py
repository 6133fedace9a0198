"""exp2: optimize the multigrid interpolation matrix by differentiable simulation.

Port of `fem_simulation_tpu/models/train_interp.py`. The two-level cycle is
an ordinary torch function of the per-triplet scalar weights and autograd
differentiates it: its coarse block-Jacobi solve goes through
`ops.ell_kernels.EllJacobiFn`, whose backward on CUDA tensors is one
hand-written `ell_jacobi_bwd` launch an iteration (lam, b's gradient and the
whole values' gradient row; from the zero start it reads no x_t). One
iteration from zero sends no gradient through the transposed matrix, so
`ell_spmv_t` is not launched here, and `ell_outer` is not either.

* Mode "P"     - train the residual-side transfer (restriction of the
  residual and prolongation of the coarse correction).
* Mode "p_hat" - train the position-side restriction that builds the coarse
  linearization point.
* Loss = post-cycle fine residual (inf-norm or squared l2) + row-norm
  penalty sum_rows (row_sum - 1)^2; clamped SGD or Adam to [0, 1].

The JAX package's `lax.scan` over training steps becomes a host loop with
the per-step losses kept on the device and read back once; its
`dispatch_chunk` (a TPU worker's dispatch limit) is gone, and the probe
residual keeps its schedule (`probe_every`). Scatter-adds over the triplets
are gathers through tables built once on the host (`ops.spring.
gather_table`), so their sums run in a fixed order. Weights persist as
numpy .npz in the JAX package's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import TrainInterpConfig
from ..ops import ell, spring, transfer as tops
from ..sim import quasistatic as qs
from ..sim.scene import Scene
from ..solvers import smoothers

_ADAM = (0.9, 0.999, 1e-8)           # b1, b2, eps of the reference's kernels


def tables_from_weights(params_t, w, nf: int, nc: int, Kr: int):
    """Rebuild the (Nf, 8) P-table and (Nc, Kr) R-table from triplet weights
    (each triplet owns one slot of each table)."""
    p_w = w.new_zeros((nf * 8,)).index_put((params_t["t_fine_slot"].long(),),
                                           w)
    r_w = w.new_zeros((nc * Kr,)).index_put(
        (params_t["t_coarse_slot"].long(),), w)
    return p_w.reshape(nf, 8), r_w.reshape(nc, Kr)


def row_table(params_t, n_rows: int, mode: str) -> torch.Tensor:
    """The gather table of the trained matrix's rows (`spring.gather_table`
    of the triplets' fine rows in mode "P", coarse columns in "p_hat"), on
    the weights' device."""
    idx = params_t["t_rows"] if mode == "P" else params_t["t_cols"]
    return torch.from_numpy(spring.gather_table(
        idx.detach().cpu().numpy(), n_rows)).to(idx.device)


def row_norm_penalty(params_t, w, n_rows: int, mode: str, table=None):
    """sum over rows of (row_sum - 1)^2, in the trained matrix's own
    normalization: mode "P" trains the hat prolongation whose FINE rows
    partition unity; mode "p_hat" the normalized restriction whose COARSE
    rows sum to 1. `table`: `row_table(params_t, n_rows, mode)` (built now
    when None)."""
    if table is None:
        table = row_table(params_t, n_rows, mode)
    s = spring.gather_sum(w, table)
    return torch.sum((s - 1.0) ** 2)


def two_level_cycle(scene: Scene, params, w, x, mode: str):
    """Differentiable 2-level cycle; returns the post-cycle positions:
    restrict residual -> coarse re-discretized Hessian at restricted
    positions -> 1 Jacobi -> prolongate -> apply."""
    t = params["transfers"][0]
    nf = scene.level(0).n_verts
    nc = scene.level(1).n_verts
    p_w, r_w = tables_from_weights(t, w, nf, nc, t["r_idx"].shape[1])

    # classic tables where the mode does not train them
    p_res = p_w if mode == "P" else t["p_w"]
    r_res = r_w if mode == "P" else t["r_w"]
    r_pos = r_w if mode == "p_hat" else t["r_w_norm"]

    f = qs.total_force(scene, params, x)
    xc = tops.restrict(t["r_idx"], r_pos, x)
    valsc = qs.assemble_coarse_rediscretized(scene, params, 1, xc,
                                             with_fix_diag=True)
    bc = tops.restrict(t["r_idx"], r_res, f)
    op1 = scene.make_op(1, params)
    dxc = smoothers.jacobi(op1, valsc, bc, iterations=1)
    return x + tops.prolong(t["p_idx"], p_res, dxc)


def two_level_cycle_residual(scene: Scene, params, w, x, mode: str):
    """Post-cycle fine residual (the reference's taped loss input)."""
    return qs.total_force(scene, params,
                          two_level_cycle(scene, params, w, x, mode))


def make_loss(scene: Scene, cfg: TrainInterpConfig, aux: bool = False):
    """Training loss loss(w, params, x). aux=True returns
    (total, (data_term, penalty)). cfg.unroll chained cycles, the residual
    summed after each; "l2" sums r^2, "inf" takes max |r| (torch.amax: a
    tie splits the gradient evenly, as the JAX package's max does)."""
    n_rows = (scene.level(0).n_verts if cfg.mode == "P"
              else scene.level(1).n_verts)
    table = row_table(scene.params["transfers"][0], n_rows, cfg.mode)

    def loss(w, params, x):
        t = params["transfers"][0]
        data = 0.0
        for _ in range(cfg.unroll):
            x = two_level_cycle(scene, params, w, x, cfg.mode)
            r = qs.total_force(scene, params, x)
            if cfg.loss == "l2":
                data = data + torch.sum(r * r)
            else:
                data = data + torch.amax(torch.abs(r))
        pen = row_norm_penalty(t, w, n_rows, cfg.mode,
                               table if params is scene.params else None)
        total = data + cfg.row_norm_weight * pen
        if aux:
            return total, (data, pen)
        return total

    return loss


class InterpTrainer:
    """Equivalent of exp2's Object.train/save/compare workflow, on the
    scene's device."""

    def __init__(self, scene: Scene, cfg: TrainInterpConfig = TrainInterpConfig()):
        if scene.n_levels < 2:
            raise ValueError("interpolation training needs >= 2 levels")
        self.scene = scene
        self.cfg = cfg
        t = scene.params["transfers"][0]
        # init from the classic weights in the mode's own normalization
        self.w = (t["t_w"] if cfg.mode == "P" else t["t_w_norm"]).clone()
        self.n_rows = (scene.level(0).n_verts if cfg.mode == "P"
                       else scene.level(1).n_verts)
        self._rows = (t["t_rows"] if cfg.mode == "P" else t["t_cols"]).long()
        self._row_table = row_table(t, self.n_rows, cfg.mode)
        self._loss = make_loss(scene, cfg, aux=True)
        self.history = None

    @property
    def device(self) -> torch.device:
        return self.scene.device

    def loss_and_grad(self, w, x):
        """(total, data, penalty, d total / d w) at weights w and state x."""
        w = w.detach().requires_grad_(True)
        total, (data, pen) = self._loss(w, self.scene.params, x)
        (g,) = torch.autograd.grad(total, w)
        return total.detach(), data.detach(), pen.detach(), g

    def _probe(self, w, x_probe):
        """||f||_inf after max(unroll, 4) bare cycles from the fixed probe
        state."""
        with torch.no_grad():
            xx = x_probe
            for _ in range(max(self.cfg.unroll, 4)):
                xx = two_level_cycle(self.scene, self.scene.params, w, xx,
                                     self.cfg.mode)
            return float(ell.inf_norm(qs.total_force(
                self.scene, self.scene.params, xx)))

    def schedule(self, iterations: int, seed: int = 0):
        """The perturbation schedule of a `train(iterations, seed)` run, the
        JAX package's: (pinned vertex ids, the vertex moved at each step,
        the float32 moves (iterations, 3) of +- perturb)."""
        rng = np.random.default_rng(seed)
        p0 = self.scene.params["levels"][0]
        pin_ids = np.nonzero(p0["pin_mask"].detach().cpu().numpy() > 0)[0]
        vids = pin_ids[rng.integers(len(pin_ids), size=iterations)]
        deltas = self.cfg.perturb * rng.choice([-1.0, 1.0],
                                               size=(iterations, 3))
        return pin_ids, vids, deltas.astype(np.float32)

    def train(self, iterations: int | None = None, seed: int = 0,
              probe_every: int | None = None):
        """Clamped-SGD/Adam training from the perturbation schedule of the
        JAX package (random +- `perturb` of a pinned vertex a step, drawn
        with np.random.default_rng(seed)). The fixed-probe residual is
        taken before the first step and every `probe_every` steps (default:
        the JAX package's chunk, max(500 // unroll, 50)) and after the last.
        Returns the loss history (loss at the pre-update weights, a step
        each); `self.history` holds its parts and the probe series."""
        cfg = self.cfg
        iterations = iterations or cfg.iterations
        if probe_every is None:
            probe_every = max(500 // cfg.unroll, 50)
        pin_ids, vids, deltas = self.schedule(iterations, seed)
        dev = self.device
        deltas = torch.from_numpy(deltas).to(dev)
        x0 = self.scene.x0
        x_probe = x0.clone()
        x_probe[int(pin_ids[0])] += torch.full((3,), cfg.perturb,
                                               dtype=x0.dtype, device=dev)

        w = self.w.detach().clone()
        m = torch.zeros_like(w)
        v = torch.zeros_like(w)
        step_t = torch.zeros((), dtype=w.dtype, device=dev)
        b1, b2, eps = _ADAM
        losses, datas, pens = [], [], []
        probes = [(0, self._probe(w, x_probe))]
        for it in range(iterations):
            x = x0.clone()
            x[int(vids[it])] += deltas[it]
            total, data, pen, g = self.loss_and_grad(w, x)
            losses.append(total)
            datas.append(data)
            pens.append(pen)
            with torch.no_grad():
                if cfg.optimizer == "adam":
                    # the reference's Adam moment kernels
                    # (cublas.py:172-197) on the interp weights
                    step_t = step_t + 1.0
                    m = b1 * m + (1.0 - b1) * g
                    v = b2 * v + (1.0 - b2) * g * g
                    mh = m / (1.0 - b1 ** step_t)
                    vh = v / (1.0 - b2 ** step_t)
                    step = cfg.lr * mh / (torch.sqrt(vh) + eps)
                else:
                    step = cfg.lr * g
                w = torch.clamp(w - step, 0.0, 1.0)
                if cfg.project_rows:
                    # hard partition of unity: trained rows renormalized
                    s = spring.gather_sum(w, self._row_table)
                    w = w / torch.clamp(s[self._rows], min=1e-6)
            done = it + 1
            if done % probe_every == 0 or done == iterations:
                probes.append((done, self._probe(w, x_probe)))
        self.w = w
        hist = torch.stack([torch.stack(losses), torch.stack(datas),
                            torch.stack(pens)]).cpu().numpy()
        self.history = {
            "loss": hist[0],
            "data": hist[1],
            "penalty": hist[2],
            "probe_steps": np.asarray([p[0] for p in probes]),
            "probe_resid": np.asarray([p[1] for p in probes]),
        }
        return hist[0]

    def rigid_transfer_error(self):
        """Max row-sum deviation from 1 of the TRAINED matrix: how far its
        rows are from transferring rigid modes (constant fields) exactly."""
        t = self.scene.params["transfers"][0]
        nf = self.scene.level(0).n_verts
        nc = self.scene.level(1).n_verts
        with torch.no_grad():
            p_w, r_w = tables_from_weights(t, self.w, nf, nc,
                                           t["r_idx"].shape[1])
            if self.cfg.mode == "P":
                out = tops.prolong(t["p_idx"], p_w,
                                   self.w.new_ones((nc, 1)))
            else:
                out = tops.restrict(t["r_idx"], r_w,
                                    self.w.new_ones((nf, 1)))
            return float(torch.max(torch.abs(out - 1.0)))

    def save(self, path: str):
        np.savez(path, w=self.w.detach().cpu().numpy(), mode=self.cfg.mode)

    def load(self, path: str):
        data = np.load(path, allow_pickle=True)
        self.w = torch.from_numpy(np.asarray(data["w"], np.float32)).to(
            self.device)
        return self

    def compare(self, iterations: int = 5, x=None, smooth: bool = False):
        """Classic vs trained transfer: per-cycle fine residual inf-norms.

        smooth=False (default) is the reference's own compare, the BARE
        cycle iterated, exactly the operator the training loss optimizes.
        smooth=True prepends a fine colored-GS sweep per cycle. Each weight
        set's series stays on the device and is read back once."""
        t = self.scene.params["transfers"][0]
        w_classic = t["t_w"] if self.cfg.mode == "P" else t["t_w_norm"]
        x0 = self.scene.x0 if x is None else x
        out = {}
        with torch.no_grad():
            for name, w in (("classic", w_classic), ("trained", self.w)):
                x_cur, series = x0, []
                for _ in range(iterations):
                    if smooth:
                        x_cur = self._fine_smooth(x_cur)
                    x_cur = self._apply_cycle(w, x_cur)
                    series.append(ell.inf_norm(qs.total_force(
                        self.scene, self.scene.params, x_cur)))
                out[name] = torch.stack(series).cpu().numpy()
        return out

    def _fine_smooth(self, x):
        """One fine colored-GS sweep (the FAS pre-smoothing)."""
        vals = qs.assemble_fine(self.scene, self.scene.params, x)
        b = qs.total_force(self.scene, self.scene.params, x)
        op0 = self.scene.make_op(0, self.scene.params)
        dx = smoothers.gauss_seidel(op0, vals, b, iterations=1)
        return x + dx

    def _apply_cycle(self, w, x):
        return two_level_cycle(self.scene, self.scene.params, w, x,
                               self.cfg.mode)
