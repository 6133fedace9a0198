"""exp3: learn a neural network that solves/initializes the implicit step.

Port of `fem_simulation_tpu/models/train_solver.py`:

* data generation: roll `frames` dynamic frames from a random initial
  velocity; ground truth x = `n_iters` Newton(CG) iterations per frame;
  inputs are the inertia prediction x_tilde concatenated with the rest
  positions. The CG matvecs are the block-ELL SpMV kernel (`ell_spmv`).
* training: MDN3(cat(x_tilde, X_rest)) against the ground truth, MSE (or the
  implicit-Euler force residual of the prediction), Adam (optax.adam
  becomes torch.optim.Adam with the same betas and eps).
* eval: residual inf-norm of the net prediction as the implicit-step
  solution; warm-start value of the prediction as Newton's initial guess.
* learned stepper: the net forward REPLACES the per-frame solve.
* multi-level variant: per-level restricted inputs into MultiLevel3.
* train_energy_gcn: a GCN optimized through the differentiable total energy.

The JAX package's `lax.scan` loops become host loops, their per-step losses
kept on the device and read back once. Random initial velocities come from
a `torch.Generator` seeded with `seed`, or are passed in (`v0`): JAX's
PRNG gives other numbers from the same seed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import DynamicsConfig, TrainSolverConfig
from ..ops import ell, transfer as tops
from ..sim import dynamic
from ..sim import quasistatic as qs
from ..sim.scene import Scene
from ..solvers import cg as cgmod
from ..utils import io as uio
from .gnn import MDN3, MultiLevel3, graph_from_topology


def initial_velocity(scene: Scene, seed: int = 0, v0_scale: float = 0.1):
    """v0_scale * a standard normal (N, 3) on the scene's device, from a
    torch.Generator seeded with `seed`."""
    gen = torch.Generator(device=scene.device).manual_seed(int(seed))
    return v0_scale * torch.randn(tuple(scene.x0.shape), generator=gen,
                                  dtype=scene.x0.dtype, device=scene.device)


def _start_state(scene: Scene, seed: int, v0_scale: float, v0):
    st = dynamic.init_state(scene)
    if v0 is None:
        v = initial_velocity(scene, seed, v0_scale)
    else:
        v = (v0 if torch.is_tensor(v0) else torch.from_numpy(
            np.asarray(v0, np.float32))).to(device=scene.device,
                                            dtype=st.v.dtype)
    return st._replace(v=v)


# ---------------------------------------------------------------------------
# Data generation
# ---------------------------------------------------------------------------

def generate_rollout(scene: Scene, cfg: TrainSolverConfig,
                     dyn: DynamicsConfig = DynamicsConfig(), seed: int = 0,
                     v0_scale: float = 0.1, v0=None):
    """Roll `cfg.frames` frames; per frame record (x_tilde, x_solved,
    ||f||_inf of the solved frame). Ground truth = cfg.n_iters Newton(CG)
    iterations a frame. The initial velocity is `v0` (N, 3) when given
    (e.g. the JAX package's v0_scale * normal(PRNGKey(seed))), else
    `initial_velocity(scene, seed, v0_scale)`. Returns device tensors
    (F, N, 3), (F, N, 3), (F,)."""
    with torch.no_grad():
        st = _start_state(scene, seed, v0_scale, v0)
        inv_dt = 1.0 / dyn.dt
        op = scene.make_op(0, scene.params)
        x_tildes, x_solved, res_inf = [], [], []
        for _ in range(cfg.frames):
            x_old = st.x
            v = st.v * dyn.damping
            x = st.x + v * dyn.dt
            x_tilde = x
            for _ in range(cfg.n_iters):
                vals = dynamic._dyn_hessian(scene, scene.params, st, x, inv_dt)
                f = dynamic._dyn_force(scene, scene.params, st, x, x_tilde,
                                       inv_dt)
                x = x + cgmod.cg(op, vals, f,
                                 iterations=scene.solver.cg_iterations,
                                 tol=scene.solver.cg_tol)
            v = (x - x_old) * inv_dt
            res = dynamic._dyn_force(scene, scene.params, st, x, x_tilde,
                                     inv_dt)
            st = st._replace(x=x, v=v)
            x_tildes.append(x_tilde)
            x_solved.append(x)
            res_inf.append(ell.inf_norm(res))
        return (torch.stack(x_tildes), torch.stack(x_solved),
                torch.stack(res_inf))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _elapsed_ms(fn, device) -> float:
    """Time of fn() in ms: CUDA events on a GPU, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


class SolverNetTrainer:
    """MDN3 / MultiLevel3 training on rollout data (reference train /
    train_muti_level), on the scene's device."""

    def __init__(self, scene: Scene, cfg: TrainSolverConfig = TrainSolverConfig(),
                 multilevel: bool = False, predict_delta: bool = False):
        # predict_delta: regress x - x_tilde instead of absolute x (much
        # better conditioned for short training runs)
        self.predict_delta = predict_delta
        self.scene = scene
        self.cfg = cfg
        self.multilevel = multilevel and scene.n_levels >= 2
        dev = scene.device
        n_lv = scene.n_levels if self.multilevel else 1
        self.graphs = [graph_from_topology(scene.level(i).nbr,
                                           scene.level(i).nbr_mask, dev)
                       for i in range(n_lv)]
        self.graph = self.graphs[0]
        if self.multilevel:
            self.prolongs = self._composed_prolongs()
        self.model = None

    @property
    def device(self) -> torch.device:
        return self.scene.device

    def _composed_prolongs(self):
        """Per coarse level: a callable prolongating its features to the
        fine grid by chaining per-hop prolong applications."""
        ts = self.scene.params["transfers"]
        prolongs = []
        for li in range(1, self.scene.n_levels):
            chain = [(ts[k]["p_idx"], ts[k]["p_w_norm"]) for k in range(li)]

            def apply_chain(h, chain=chain):
                for (pi, pw) in reversed(chain):
                    h = tops.prolong(pi, pw, h)
                return h

            prolongs.append(apply_chain)
        return prolongs

    def _features(self, x_tilde):
        return torch.cat([x_tilde, self.scene.x0], dim=-1)   # (N, 6)

    def _multilevel_inputs(self, x_tilde):
        """Per-level features: restricted x_tilde ++ that level's rest
        positions."""
        ts = self.scene.params["transfers"]
        xs = [self._features(x_tilde)]
        xt = x_tilde
        for li in range(1, self.scene.n_levels):
            t = ts[li - 1]
            xt = tops.restrict(t["r_idx"], t["r_w_norm"], xt)
            x0c = self.scene.params["levels"][li]["x0"]
            xs.append(torch.cat([xt, x0c], dim=-1))
        return xs

    def _forward(self, x_tilde):
        if self.multilevel:
            out = self.model(self._multilevel_inputs(x_tilde), self.graphs,
                             self.prolongs)
        else:
            out = self.model(self._features(x_tilde), self.graph)
        return x_tilde + out if self.predict_delta else out

    def make_model(self, generator: torch.Generator | None = None):
        """A new model of this trainer's kind on the scene's device."""
        cfg = self.cfg
        if self.multilevel:
            model = MultiLevel3(self.scene.n_levels, feat_dim=cfg.feat_dim,
                                hidden=cfg.hidden_channels,
                                generator=generator)
        else:
            model = MDN3(feat_dim=cfg.feat_dim, hidden=cfg.hidden_channels,
                         generator=generator)
        return model.to(self.device)

    def init(self, seed: int = 0):
        """Fresh weights (flax Dense's distribution, a torch.Generator
        seeded with `seed`)."""
        self.model = self.make_model(torch.Generator().manual_seed(int(seed)))
        return self.model

    def load_state_dict(self, state_dict):
        """Weights from a state_dict (e.g. `gnn.params_from_flax` of the JAX
        package's parameter tree)."""
        if self.model is None:
            self.model = self.make_model()
        self.model.load_state_dict(state_dict)
        return self

    def loss_fn(self, xt, xs):
        """The training loss of one sample (x_tilde, x_solved)."""
        pred = self._forward(xt)
        if self.cfg.loss == "residual":
            # the implicit-Euler force residual of the prediction, xt the
            # inertia anchor of its frame; rollouts carry no drag
            st0 = dynamic.init_state(self.scene)
            f = dynamic._dyn_force(self.scene, self.scene.params, st0, pred,
                                   xt, 1.0 / DynamicsConfig().dt)
            return torch.mean(f * f)
        return torch.mean((pred - xs) ** 2)

    def train(self, iterations: int | None = None, seed: int = 0,
              rollouts: int = 1, frames: int | None = None):
        """Generate rollouts (seeds seed, seed + 1, ...) and fit
        x = net(x_tilde ++ X) by Adam on samples drawn with
        np.random.default_rng(seed); returns the losses (numpy)."""
        cfg = self.cfg
        if frames is not None:
            cfg = dataclasses.replace(cfg, frames=frames)
        xt_list, xs_list = [], []
        for r in range(rollouts):
            xt, xsol, _ = generate_rollout(self.scene, cfg, seed=seed + r)
            xt_list.append(xt)
            xs_list.append(xsol)
        X_t = torch.cat(xt_list)                        # (F, N, 3)
        X_s = torch.cat(xs_list)
        if self.model is None:
            self.init(seed)
        opt = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        iterations = iterations or cfg.train_times
        rng = np.random.default_rng(seed)
        idxs = rng.integers(X_t.shape[0], size=iterations)
        losses = []
        for idx in idxs:
            opt.zero_grad(set_to_none=True)
            loss = self.loss_fn(X_t[int(idx)], X_s[int(idx)])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).cpu().numpy()

    def evaluate_residual(self, x_tilde, st=None):
        """||f||_inf of the net prediction as an implicit-step solution."""
        if st is None:
            st = dynamic.init_state(self.scene)
        with torch.no_grad():
            pred = self._forward(x_tilde)
            f = dynamic._dyn_force(self.scene, self.scene.params, st, pred,
                                   x_tilde, 1.0 / DynamicsConfig().dt)
            return float(ell.inf_norm(f))

    def warmstart_stats(self, frames: int = 30, tol: float = 1e-4,
                        max_newton: int = 20, seed: int = 123,
                        v0_scale: float = 0.1,
                        dyn: DynamicsConfig = DynamicsConfig(), v0=None):
        """The learned solver's value AS AN INITIALIZER: per frame of a
        held-out rollout, solve the same implicit step twice, Newton from
        the inertia predictor (plain) and Newton seeded at the net
        prediction (warm), and count iterations. The trajectory advances
        with the plain solution.

        Returns per-frame arrays (k_plain, k_warm, fn_plain, fn_warm) and
        the best of three timed rollouts, a solve a frame each (the warm one
        with the net forward), in ms a frame: CUDA events on a GPU, the host
        clock on the CPU."""
        scene = self.scene
        st0 = _start_state(scene, seed, v0_scale, v0)

        def solve(st, x_init):
            return dynamic.step_to_tol(
                scene, scene.params, st, dyn, tol=tol,
                max_newton=max_newton, use_multigrid=False,
                matrix_free=True, x_init=x_init)

        def predict(st):
            return self._forward(st.x + st.v * dyn.damping * dyn.dt)

        k_p, k_w, f_p, f_w = [], [], [], []
        with torch.no_grad():
            st = st0
            for _ in range(frames):
                pred = predict(st)
                st_p, kp, fp = solve(st, None)
                _, kw, fw = solve(st, pred)
                st = st_p
                k_p.append(kp)
                k_w.append(kw)
                f_p.append(fp)
                f_w.append(fw)

            def roll(warm):
                st = st0
                for _ in range(frames):
                    st, _, _ = solve(st, predict(st) if warm else None)

            times = {}
            for name, warm in (("plain", False), ("warm", True)):
                roll(warm)                               # warm-up
                times[name] = min(_elapsed_ms(lambda: roll(warm), self.device)
                                  for _ in range(3)) / frames
        return {"k_plain": np.asarray(k_p), "k_warm": np.asarray(k_w),
                "fn_plain": np.asarray(f_p, np.float32),
                "fn_warm": np.asarray(f_w, np.float32),
                "ms_plain": times["plain"], "ms_warm": times["warm"]}

    def learned_step(self, st: dynamic.DynState,
                     dyn: DynamicsConfig = DynamicsConfig()):
        """test_render: the net forward REPLACES the solver."""
        inv_dt = 1.0 / dyn.dt
        with torch.no_grad():
            x_old = st.x
            v = st.v * dyn.damping
            x_tilde = st.x + v * dyn.dt
            x = self._forward(x_tilde)
            v = (x - x_old) * inv_dt
        return st._replace(x=x, v=v)

    def save(self, path: str):
        """The weights as an npz pytree (`utils.io.save_pytree`)."""
        uio.save_pytree(path, dict(self.model.state_dict()))

    def load(self, path: str):
        if self.model is None:
            self.model = self.make_model()
        like = dict(self.model.state_dict())
        self.model.load_state_dict(uio.load_pytree(path, like))
        return self


# ---------------------------------------------------------------------------
# exp3/quasi: GCN through differentiable energy
# ---------------------------------------------------------------------------

def train_energy_gcn(scene: Scene, iterations: int = 200, lr: float = 1e-3,
                     seed: int = 0, model: MDN3 | None = None):
    """Optimize a GCN whose output displaces vertices to minimize the total
    energy (qs.total_energy is differentiable: no tape bridge). `model`:
    an MDN3(feat_dim=4, hidden=64) to start from (default: a new one with
    weights from `seed`). Returns (model, losses)."""
    lvl0 = scene.level(0)
    graph = graph_from_topology(lvl0.nbr, lvl0.nbr_mask, scene.device)
    if model is None:
        model = MDN3(feat_dim=4, hidden=64,
                     generator=torch.Generator().manual_seed(int(seed)))
    model = model.to(scene.device)
    feats = torch.cat([scene.x0, scene.x0], dim=-1)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(iterations):
        opt.zero_grad(set_to_none=True)
        dx = model(feats, graph)
        loss = qs.total_energy(scene, scene.params, scene.x0 + 0.01 * dx)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return model, torch.stack(losses).cpu().numpy()
